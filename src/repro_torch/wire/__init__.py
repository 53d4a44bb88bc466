"""repro_torch.wire: the update-encoding codec layer (port of
``repro.wire``, DESIGN.md §10).

    codec   leaf and tree encode/decode, sizing formulas, quantization
            (the CUDA kernels B4/B5 under impl 'cuda')
    framing length-prefixed messages, vectored send, the Transport seam
            (make_transport) and its TCP Connection
    shm     the shared-memory ring-buffer Transport (DESIGN.md §12)

Names are imported on first use: the broker reads ``framing`` only and
imports no torch. ``PALLAS_AUTO_MIN_N`` and ``pallas_ok``, the JAX
package's names, are the codec's ``CUDA_AUTO_MIN_N`` and ``cuda_ok``.
"""

from repro_torch._exports import lazy

_C = "repro_torch.wire.codec"
_F = "repro_torch.wire.framing"
__getattr__ = lazy(__name__, {
    **{name: (_C, name) for name in (
        "AUTO", "IMPLS", "INT32_MAX", "CUDA_AUTO_MIN_N", "QUANTS",
        "SCHEMES", "best_scheme", "cuda_ok", "decode_add_leaf",
        "decode_leaf", "decode_tree", "encode_leaf", "encode_tree",
        "encode_tree_parts", "index_dtype", "index_itemsize", "leaf_nbytes",
        "mask_nbytes", "predict_leaf_nbytes", "predict_tree_nbytes",
        "quant_dtype", "resolve_impl", "tree_keys", "tree_nbytes")},
    "PALLAS_AUTO_MIN_N": (_C, "CUDA_AUTO_MIN_N"),
    "pallas_ok": (_C, "cuda_ok"),
    **{name: (_F, name) for name in (
        "MAX_MSG_BYTES", "TRANSPORTS", "Connection", "Transport",
        "make_transport", "pack_parts", "pipelined", "recv_msg", "request",
        "send_msg", "unpack_parts")},
})

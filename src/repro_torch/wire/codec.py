"""Unified update-encoding codec (port of ``repro.wire.codec``).

One byte-accounting truth: ``leaf_nbytes`` is the single sizing formula and
every encode asserts its output length against it. Schemes per leaf:
``dense`` raw values, ``sparse`` int32 flat indices + values, ``bitmap``
little-endian packed mask + values, ``auto`` the smallest (ties prefer
sparse, then bitmap). ``fp16``/``bf16`` quantize float values, with the
error returned as a float32 error-feedback residual.

The numpy body is the JAX package's, unchanged: it is the byte-level
reference. The ``impl`` seam picks the encoder:

* ``numpy`` — the reference body on the host (the tensor crosses first);
* ``cuda`` — the fused kernels of ``kernels.wire_pack`` (B4 encode, B5
  decode/apply) where the leaf lies; only the wire bytes cross to the
  host. On a CPU tensor the kernels' plain versions run;
* ``auto`` — ``cuda`` for leaves of at least ``CUDA_AUTO_MIN_N`` elements.

Every impl gives bit-identical bytes, metas and residuals. bfloat16 reaches
numpy through ``ml_dtypes`` (a torch bf16 tensor has no ``.numpy()``).
"""

from __future__ import annotations

from typing import Any, Optional

import ml_dtypes
import numpy as np
import torch

from repro_torch import tree as tree_lib

PyTree = Any

SCHEMES = ("dense", "sparse", "bitmap")
AUTO = "auto"
QUANTS = ("none", "fp16", "bf16")

INT32_MAX = 2**31 - 1  # flat-index overflow bound

_BF16 = np.dtype(ml_dtypes.bfloat16)

IMPLS = ("numpy", "cuda", "auto")
CUDA_AUTO_MIN_N = 1 << 15  # the JAX package's PALLAS_AUTO_MIN_N
# dtypes the kernel path takes (the JAX package's _PALLAS_DTYPES)
_CUDA_DTYPES = frozenset(("float32", "float16", "bfloat16", "int32"))
# fused decode/apply: exact accumulates only (the JAX package's
# _PALLAS_ADD_DTYPES)
_CUDA_ADD_DTYPES = frozenset(("float32", "int32"))

_TORCH_OF = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int32": torch.int32,
}


def cuda_ok(n: int, dtype: Any, quant: str = "none") -> bool:
    """Can the kernel path encode this leaf bit-identically?"""
    dt = np.dtype(dtype)
    return (
        0 < n <= INT32_MAX
        and dt.name in _CUDA_DTYPES
        and quant_dtype(dt, quant).name in _CUDA_DTYPES
    )


def resolve_impl(impl: str, n: int, dtype: Any, quant: str = "none") -> str:
    """'auto'/'cuda' -> the impl actually used for this leaf (numpy where
    the kernel cannot hold bit-identity for it)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "numpy" or not cuda_ok(n, dtype, quant):
        return "numpy"
    if impl == "auto" and n < CUDA_AUTO_MIN_N:
        return "numpy"
    return "cuda"


# -- host <-> tensor ----------------------------------------------------------


def np_dtype(dtype: Any) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (bf16 via ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return _BF16
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def to_numpy(x: Any) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor crosses to the host)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(x)


def to_tensor(a: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    """A tensor on ``device`` holding a copy of numpy array ``a``."""
    a = np.array(a, order="C")  # a writable copy; keeps 0-d shapes
    if a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_dtype(x: Any) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return np_dtype(x.dtype)
    return np.asarray(x).dtype


# -- sizing: the one formula every layer reads --------------------------------


def index_itemsize(n: int) -> int:
    """Bytes per flat index for an ``n``-element leaf (int32 until 2**31)."""
    return 4 if n <= INT32_MAX else 8


def index_dtype(n: int) -> np.dtype:
    """int32 flat indices, widened to int64 for leaves with >= 2**31
    elements."""
    return np.dtype(np.int32 if n <= INT32_MAX else np.int64)


def mask_nbytes(n: int) -> int:
    """Bytes of the packed significance bitmap for an ``n``-element leaf."""
    return (n + 7) // 8


def quant_dtype(dtype: Any, quant: str = "none") -> np.dtype:
    """Wire value dtype for a leaf dtype under a quantization mode.

    Only floating leaves quantize; integer/bool leaves pass through.
    """
    dt = np.dtype(dtype)
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if quant == "none" or dt.kind != "f":
        return dt
    if quant == "fp16":
        return np.dtype(np.float16)
    return _BF16


def leaf_nbytes(scheme: str, n: int, nnz, itemsize: int = 4):
    """Wire bytes of one encoded leaf. THE sizing formula."""
    if scheme == "dense":
        return n * itemsize
    if scheme == "sparse":
        return nnz * (index_itemsize(n) + itemsize)
    if scheme == "bitmap":
        return mask_nbytes(n) + nnz * itemsize
    raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")


def best_scheme(n: int, nnz: int, itemsize: int = 4) -> str:
    """The ``auto`` resolution: smallest encoding for this leaf
    (ties prefer sparse, then bitmap — sparse decodes cheapest)."""
    order = ("sparse", "bitmap", "dense")
    sizes = {s: leaf_nbytes(s, n, nnz, itemsize) for s in order}
    return min(order, key=lambda s: sizes[s])


# -- leaf encode / decode -----------------------------------------------------


def encode_leaf(
    arr: Any,
    scheme: str = AUTO,
    quant: str = "none",
    key: Optional[str] = None,
    with_residual: bool = False,
    impl: str = "numpy",
) -> tuple[dict, list, Any]:
    """Encode one array or tensor -> (meta, buffer parts, optional float32
    residual).

    ``parts`` are read-only byte views (``b"".join`` them or hand them to
    the vectored framing layer). ``meta``: k, shape, dtype, enc, nnz,
    nbytes (+ ``q`` when values are quantized, ``idx: 'int64'`` when
    indices widened). The residual (``arr - decode(encode(arr))``) is a
    tensor on ``arr``'s device when ``arr`` is a tensor, else numpy.
    """
    n = int(arr.numel()) if isinstance(arr, torch.Tensor) else int(
        np.asarray(arr).size)
    dt = _leaf_dtype(arr)
    if resolve_impl(impl, n, dt, quant) == "cuda":
        return _encode_leaf_cuda(arr, scheme=scheme, quant=quant, key=key,
                                 with_residual=with_residual)
    meta, parts, residual = _encode_leaf_numpy(
        to_numpy(arr), scheme, quant, key, with_residual)
    if residual is not None and isinstance(arr, torch.Tensor):
        residual = to_tensor(residual, arr.device)
    return meta, parts, residual


def _encode_leaf_numpy(a, scheme, quant, key, with_residual):
    """The reference encoder (the JAX package's numpy body)."""
    dt = a.dtype
    vdt = quant_dtype(dt, quant)
    flat = np.ascontiguousarray(a).reshape(-1)
    n = int(flat.size)
    nz = np.flatnonzero(flat)
    nnz = int(nz.size)
    if scheme == AUTO:
        scheme = best_scheme(n, nnz, vdt.itemsize)
    meta: dict = {
        "k": key,
        "shape": list(a.shape),
        "dtype": str(dt),
        "enc": scheme,
        "nnz": nnz,
    }
    if vdt != dt:
        meta["q"] = quant
    parts: list = []
    if scheme == "dense":
        qvals = flat if vdt == dt else flat.astype(vdt)
        parts = [_byte_view(qvals)]
    elif scheme == "sparse":
        idt = index_dtype(n)
        if idt != np.int32:
            meta["idx"] = str(idt)
        qvals = flat[nz].astype(vdt)
        parts = [_byte_view(nz.astype(idt)), _byte_view(qvals)]
    elif scheme == "bitmap":
        mask = np.packbits(flat != 0, bitorder="little")
        qvals = flat[nz].astype(vdt)
        parts = [_byte_view(mask), _byte_view(qvals)]
    else:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    nbytes = sum(len(p) for p in parts)
    expect = leaf_nbytes(scheme, n, nnz, vdt.itemsize)
    if nbytes != expect:  # the one-sizing-formula invariant
        raise AssertionError((nbytes, expect, meta))
    meta["nbytes"] = nbytes
    residual = None
    if with_residual:
        # quantization error directly from the materialized wire values —
        # zero off the nnz support, so no decode round trip is needed
        if vdt == dt:
            residual = np.zeros(a.shape, np.float32)
        elif scheme == "dense":
            residual = (
                flat.astype(np.float32) - qvals.astype(np.float32)
            ).reshape(a.shape)
        else:
            rflat = np.zeros(n, np.float32)
            rflat[nz] = (
                flat[nz].astype(np.float32) - qvals.astype(np.float32)
            )
            residual = rflat.reshape(a.shape)
    return meta, parts, residual


def _encode_leaf_cuda(arr, scheme, quant, key, with_residual):
    """Kernel encode (B4): one fused pass where the leaf lies emits the
    packed mask, quantized values (dense and compacted), flat indices, nnz
    and residual; only the first ``nnz`` wire values (or the dense values)
    cross to the host. Same meta and parts as the numpy body."""
    from repro_torch.kernels import wire_pack

    t = arr if isinstance(arr, torch.Tensor) else to_tensor(np.asarray(arr))
    dt = np_dtype(t.dtype)
    vdt = quant_dtype(dt, quant)
    shape = list(t.shape)
    n = t.numel()
    mask, qdense, cvals, cidx, nnz_t, res = wire_pack.wire_pack(
        t.contiguous().view(-1), _TORCH_OF[vdt.name])
    nnz = int(nnz_t)
    if scheme == AUTO:
        scheme = best_scheme(n, nnz, vdt.itemsize)
    meta: dict = {"k": key, "shape": shape, "dtype": str(dt), "enc": scheme,
                  "nnz": nnz}
    if vdt != dt:
        meta["q"] = quant
    if scheme == "dense":
        parts = [_byte_view(to_numpy(qdense))]
    elif scheme == "sparse":
        # the kernel path is gated to n <= INT32_MAX, so indices are int32
        parts = [_byte_view(to_numpy(cidx[:nnz])),
                 _byte_view(to_numpy(cvals[:nnz]))]
    elif scheme == "bitmap":
        parts = [_byte_view(to_numpy(mask)),
                 _byte_view(to_numpy(cvals[:nnz]))]
    else:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    nbytes = sum(len(p) for p in parts)
    expect = leaf_nbytes(scheme, n, nnz, vdt.itemsize)
    if nbytes != expect:
        raise AssertionError((nbytes, expect, meta))
    meta["nbytes"] = nbytes
    residual = None
    if with_residual:
        # f32(x) - f32(quant(x)) is zero off the support by IEEE
        # subtraction; vdt == dt short-circuits to exact zeros (inf - inf
        # would make NaNs)
        if vdt == dt:
            residual = torch.zeros(shape, dtype=torch.float32,
                                   device=t.device)
        else:
            residual = res.view(shape)
        if not isinstance(arr, torch.Tensor):
            residual = to_numpy(residual)
    return meta, parts, residual


def _byte_view(arr: np.ndarray):
    """Read-only byte view over a C-contiguous array (keeps it alive)."""
    a = np.ascontiguousarray(arr)
    return a.view(np.uint8).reshape(-1).data.cast("B")


def _leaf_geometry(meta: dict):
    shape = tuple(meta["shape"])
    dt = np.dtype(meta["dtype"]) if meta["dtype"] != "bfloat16" else _BF16
    vdt = quant_dtype(dt, meta.get("q", "none"))
    n = int(np.prod(shape)) if shape else 1
    return shape, dt, vdt, n


def decode_leaf(meta: dict, blob, impl: str = "numpy",
                device: Any = None) -> np.ndarray:
    """Decode one leaf's bytes back into a numpy array of its dtype.

    Under ``impl='cuda'``/'auto' a bitmap leaf of a float32 or int32 leaf
    goes through the B5 kernel on ``device`` (default ``cuda``); every
    other case is the numpy reference. Bit-identical across impls.
    """
    shape, dt, vdt, n = _leaf_geometry(meta)
    enc = meta["enc"]
    nnz = int(meta["nnz"])
    if (enc == "bitmap" and dt.name in _CUDA_ADD_DTYPES
            and resolve_impl(impl, n, dt, meta.get("q", "none")) == "cuda"):
        from repro_torch import device as device_lib
        from repro_torch.kernels import wire_pack

        dev = device_lib.resolve(device)
        mask, vals = _upload_bitmap(meta, blob, dev)
        out = wire_pack.wire_unpack(mask, vals, n, _TORCH_OF[dt.name])
        return to_numpy(out).reshape(shape)
    if enc == "dense":
        vals = np.frombuffer(blob, dtype=vdt, count=n)
        return (vals if vdt == dt else vals.astype(dt)).reshape(shape)
    if enc == "sparse":
        idt = np.dtype(meta.get("idx", "int32"))
        idx = np.frombuffer(blob, dtype=idt, count=nnz)
        vals = np.frombuffer(
            blob, dtype=vdt, offset=nnz * idt.itemsize, count=nnz
        )
        out = np.zeros(n, dtype=dt)
        out[idx] = vals.astype(dt)
        return out.reshape(shape)
    if enc == "bitmap":
        mb = mask_nbytes(n)
        mask = np.unpackbits(
            np.frombuffer(blob, dtype=np.uint8, count=mb),
            count=n,
            bitorder="little",
        ).astype(bool)
        vals = np.frombuffer(blob, dtype=vdt, offset=mb, count=nnz)
        out = np.zeros(n, dtype=dt)
        out[mask] = vals.astype(dt)
        return out.reshape(shape)
    raise ValueError(f"unknown leaf encoding {enc!r}")


def _upload_bitmap(meta: dict, blob, device):
    """The received mask bytes and compact values, copied to ``device``."""
    _, _, vdt, n = _leaf_geometry(meta)
    mb = mask_nbytes(n)
    nnz = int(meta["nnz"])
    mask = to_tensor(np.frombuffer(blob, dtype=np.uint8, count=mb), device)
    vals = to_tensor(
        np.frombuffer(blob, dtype=vdt, offset=mb, count=nnz), device)
    return mask, vals


def decode_add_leaf(target: torch.Tensor, meta: dict, blob,
                    impl: str = "numpy") -> torch.Tensor:
    """Decode one leaf and ADD it into flat tensor ``target`` (leaf dtype),
    returned as a new tensor on ``target``'s device. Under ``impl='cuda'``
    /'auto' a bitmap float32/int32 leaf takes the fused unpack-apply kernel
    (B5): only the wire bytes are copied to the device. Every other case
    decodes in numpy and adds on the device. Bit-identical either way —
    the float32 adds round the same and the off-support lanes still add an
    explicit +0.0."""
    _, dt, _, n = _leaf_geometry(meta)
    if (
        meta["enc"] == "bitmap"
        and dt.name in _CUDA_ADD_DTYPES
        and resolve_impl(impl, n, dt, meta.get("q", "none")) == "cuda"
    ):
        from repro_torch.kernels import wire_pack

        mask, vals = _upload_bitmap(meta, blob, target.device)
        return wire_pack.wire_unpack_add(target.reshape(-1), mask, vals)
    dec = to_tensor(decode_leaf(meta, blob).reshape(-1), target.device)
    return target.reshape(-1) + dec


# -- pytree encode / decode ---------------------------------------------------


def tree_keys(tree: PyTree) -> list[str]:
    """Stable '/'-joined path keys — the checkpoint store's scheme."""
    return tree_lib.tree_keys(tree)


def encode_tree_parts(
    tree: PyTree,
    scheme: str = AUTO,
    quant: str = "none",
    with_residual: bool = False,
    impl: str = "numpy",
) -> tuple[list[dict], list, Optional[PyTree]]:
    """Encode a pytree -> (per-leaf meta, flat buffer list, residual tree)."""
    meta: list[dict] = []
    parts: list = []
    residuals: list = []
    for key, leaf in zip(tree_keys(tree), tree_lib.leaves(tree)):
        m, p, r = encode_leaf(
            leaf, scheme=scheme, quant=quant, key=key,
            with_residual=with_residual, impl=impl,
        )
        meta.append(m)
        parts.extend(p)
        residuals.append(r)
    res_tree = tree_lib.unflatten(tree, residuals) if with_residual else None
    return meta, parts, res_tree


def encode_tree(
    tree: PyTree, scheme: str = AUTO, quant: str = "none"
) -> tuple[list[dict], bytes]:
    """Joined-payload form of ``encode_tree_parts``."""
    meta, parts, _ = encode_tree_parts(tree, scheme=scheme, quant=quant)
    return meta, b"".join(bytes(p) for p in parts)


def decode_tree(meta: list[dict], payload, like: PyTree) -> PyTree:
    """Decode bytes back into numpy leaves shaped like ``like``."""
    like_leaves = tree_lib.leaves(like)
    if len(like_leaves) != len(meta):
        raise ValueError(
            f"template has {len(like_leaves)} leaves, message {len(meta)}"
        )
    view = memoryview(payload)
    out = []
    off = 0
    for m in meta:
        nb = int(m["nbytes"])
        out.append(decode_leaf(m, view[off: off + nb]))
        off += nb
    if off != len(view):
        raise ValueError(f"trailing bytes in payload: {len(view) - off}")
    return tree_lib.unflatten(like, out)


def tree_nbytes(meta: list[dict]) -> int:
    """Payload bytes a meta list accounts for (the broker's unit of record)."""
    return int(sum(m["nbytes"] for m in meta))


def predict_leaf_nbytes(
    leaf: Any, scheme: str = AUTO, quant: str = "none"
) -> int:
    """Wire bytes ONE leaf would cost, from its nnz through ``leaf_nbytes``."""
    if isinstance(leaf, torch.Tensor):
        n, nnz = leaf.numel(), int(torch.count_nonzero(leaf))
    else:
        a = np.asarray(leaf)
        n, nnz = int(a.size), int(np.count_nonzero(a))
    isz = quant_dtype(_leaf_dtype(leaf), quant).itemsize
    s = best_scheme(n, nnz, isz) if scheme == AUTO else scheme
    return int(leaf_nbytes(s, n, nnz, isz))


def predict_tree_nbytes(
    tree: PyTree, scheme: str = AUTO, quant: str = "none"
) -> int:
    """Wire bytes this tree WOULD cost (== the encoded size)."""
    return sum(
        predict_leaf_nbytes(leaf, scheme, quant)
        for leaf in tree_lib.leaves(tree)
    )

"""B4 and B5: fused wire encode and decode/apply (``csrc/wire_pack.cu``).

Replace the Pallas TPU kernels ``repro.kernels.wire_pack.wire_pack`` and
``wire_unpack_add`` / ``wire_unpack``. Encode reads the filtered leaf once
and writes the packed mask, the quantized values (dense and compacted),
the compacted flat indices, the count and the error-feedback residual;
decode reads the mask and the compacted values and adds them into the
target. All passes stream, so the card's memory rate bounds them.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

PACK = "wire_pack"
UNPACK_ADD = "wire_unpack_add"

CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
         torch.int32: 3}
_THREADS = 256  # elements per block in the kernels


def _scratch(n: int, device: torch.device):
    nb = max((n + _THREADS - 1) // _THREADS, 1)
    counts = torch.empty(nb, dtype=torch.int32, device=device)
    offsets = torch.empty(nb, dtype=torch.int32, device=device)
    total = torch.empty((), dtype=torch.int32, device=device)
    return counts, offsets, total


def wire_pack(flat: torch.Tensor, vdt: torch.dtype):
    """Encode one flat leaf (n >= 1):
    ``(mask_bytes, qdense, cvals, cidx, nnz, residual)``.

    ``mask_bytes`` is uint8[ceil(n/8)], little-endian; ``qdense`` every
    value in ``vdt``; ``cvals``/``cidx`` the significant values and their
    int32 flat indices, front-compacted (entries past ``nnz`` are not
    defined on the card and zero in the plain version); ``nnz`` a 0-d int32
    tensor; ``residual`` float32 ``f32(x) - f32(quant(x))``.
    """
    if flat.dim() != 1 or flat.numel() < 1:
        raise ValueError(f"{PACK}: expects a non-empty 1-D tensor")
    if flat.dtype not in CODES or vdt not in CODES:
        raise TypeError(f"{PACK}: unsupported types {flat.dtype} -> {vdt}")
    if (flat.dtype == torch.int32) != (vdt == torch.int32):
        raise TypeError(f"{PACK}: int32 leaves do not quantize")
    if flat.device.type == "cpu":
        return ref.wire_pack_ref(flat, vdt)
    build.require_cuda(flat, PACK)
    n, dev = flat.numel(), flat.device
    mask = torch.empty((n + 7) // 8, dtype=torch.uint8, device=dev)
    qdense = torch.empty(n, dtype=vdt, device=dev)
    cvals = torch.empty(n, dtype=vdt, device=dev)
    cidx = torch.empty(n, dtype=torch.int32, device=dev)
    residual = torch.empty(n, dtype=torch.float32, device=dev)
    counts, offsets, nnz = _scratch(n, dev)
    lib = build.load("wire_pack")
    build.check(lib.wire_pack_launch(
        flat.data_ptr(), CODES[flat.dtype], CODES[vdt], n, mask.data_ptr(),
        qdense.data_ptr(), cvals.data_ptr(), cidx.data_ptr(),
        residual.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
        nnz.data_ptr(), build.stream_ptr(dev)), PACK)
    build.LAUNCHES[PACK] += 1
    return mask, qdense, cvals, cidx, nnz, residual


def _unpack(target, mask_bytes, cvals, n, dtype, accumulate):
    dev = mask_bytes.device
    for t, what in ((mask_bytes, "mask"), (cvals, "values")):
        build.require_cuda(t, f"{UNPACK_ADD} {what}")
        if t.device != dev:
            raise ValueError(f"{UNPACK_ADD}: tensors on {dev} and {t.device}")
    out = torch.empty(n, dtype=dtype, device=dev)
    if accumulate:
        build.require_cuda(target, f"{UNPACK_ADD} target")
        if target.device != dev:
            raise ValueError(f"{UNPACK_ADD}: target on {target.device}")
    if cvals.numel() == 0:  # nothing on the support: one dummy slot
        cvals = torch.zeros(1, dtype=cvals.dtype, device=dev)
    counts, offsets, total = _scratch(n, dev)
    lib = build.load("wire_pack")
    build.check(lib.wire_unpack_add_launch(
        (target if accumulate else out).data_ptr(), CODES[dtype],
        mask_bytes.data_ptr(), n, cvals.data_ptr(), CODES[cvals.dtype],
        counts.data_ptr(), offsets.data_ptr(), total.data_ptr(),
        out.data_ptr(), int(accumulate), build.stream_ptr(dev)), UNPACK_ADD)
    build.LAUNCHES[UNPACK_ADD] += 1
    return out


def _check_unpack(mask_bytes, cvals, n, dtype):
    if mask_bytes.dtype != torch.uint8 or mask_bytes.numel() != (n + 7) // 8:
        raise ValueError(f"{UNPACK_ADD}: mask must be uint8[ceil(n/8)]")
    ok = (dtype == torch.int32 and cvals.dtype == torch.int32) or (
        dtype == torch.float32 and cvals.dtype in
        (torch.float32, torch.float16, torch.bfloat16))
    if not ok:
        raise TypeError(f"{UNPACK_ADD}: unsupported types {cvals.dtype} -> "
                        f"{dtype} (float32 and int32 targets only)")


def wire_unpack_add(
    target: torch.Tensor, mask_bytes: torch.Tensor, cvals: torch.Tensor
) -> torch.Tensor:
    """``target + decode(mask_bytes, cvals)`` for a flat float32 or int32
    target; ``cvals`` holds at least the ``nnz`` significant values in
    flat order. Every element gets an add, ``+0`` off the support."""
    if target.dim() != 1 or target.numel() < 1:
        raise ValueError(f"{UNPACK_ADD}: expects a non-empty 1-D target")
    _check_unpack(mask_bytes, cvals, target.numel(), target.dtype)
    if target.device.type == "cpu":
        return ref.wire_unpack_add_ref(target, mask_bytes, cvals)
    return _unpack(target, mask_bytes, cvals, target.numel(), target.dtype,
                   accumulate=True)


def wire_unpack(
    mask_bytes: torch.Tensor, cvals: torch.Tensor, n: int, dtype: torch.dtype
) -> torch.Tensor:
    """Decode only: the values on the support, exact zeros elsewhere."""
    _check_unpack(mask_bytes, cvals, n, dtype)
    if mask_bytes.device.type == "cpu":
        return ref.wire_unpack_ref(mask_bytes, cvals, n, dtype)
    return _unpack(None, mask_bytes, cvals, n, dtype, accumulate=False)

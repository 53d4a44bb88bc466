"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, element for element,
and is the ground truth the kernel is held to bit for bit on the card
(``chip_smoke.py``) and against the JAX package on the CPU
(``tests/test_torch_kernels.py``). A wrapper takes its plain version only
for a tensor that lies on the CPU; nothing on the CUDA path calls these.
"""

from __future__ import annotations

import torch

_BIT = torch.arange(8, dtype=torch.uint8)


def significance_ref(
    u: torch.Tensor, x: torch.Tensor, r: torch.Tensor, v_t: float,
    floor: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """acc = r + u; split by |acc| > v_t * max(|x|, floor) -> (sig, res)."""
    acc = r + u
    f = torch.tensor(floor, dtype=torch.float32, device=x.device)
    denom = torch.maximum(x.abs(), f)
    vt = torch.tensor(v_t, dtype=torch.float32, device=x.device)
    mask = acc.abs() > vt * denom
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    return torch.where(mask, acc, zero), torch.where(mask, zero, acc)


def packbits_le(mask: torch.Tensor) -> torch.Tensor:
    """numpy's ``packbits(mask, bitorder='little')`` for a flat bool tensor."""
    n = mask.numel()
    pad = (-n) % 8
    bits = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    weights = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.uint8, device=mask.device),
        _BIT.to(mask.device))
    return (bits.view(-1, 8).to(torch.int32) * weights.to(torch.int32)).sum(
        1).to(torch.uint8)


def unpackbits_le(mask_bytes: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``unpackbits(..., count=n, bitorder='little')`` as bool."""
    shifts = _BIT.to(mask_bytes.device)
    bits = torch.bitwise_and(
        torch.bitwise_right_shift(mask_bytes.view(-1, 1), shifts), 1)
    return bits.view(-1)[:n].to(torch.bool)


def wire_pack_ref(flat: torch.Tensor, vdt: torch.dtype):
    """Fused encode of one flat leaf:
    ``(mask_bytes, qdense, cvals, cidx, nnz, residual)`` — the packed
    little-endian mask, every value quantized to ``vdt``, the significant
    values and their int32 flat indices compacted to the front (zeros
    after ``nnz``), the count as a 0-d int32 tensor, and the float32
    residual ``f32(x) - f32(quant(x))``."""
    n = flat.numel()
    mask = flat != 0
    q = flat.to(vdt)
    residual = flat.to(torch.float32) - q.to(torch.float32)
    idx = torch.nonzero(mask).view(-1)
    nnz = idx.numel()
    cvals = torch.zeros(n, dtype=vdt, device=flat.device)
    cvals[:nnz] = q[idx]
    cidx = torch.zeros(n, dtype=torch.int32, device=flat.device)
    cidx[:nnz] = idx.to(torch.int32)
    count = torch.tensor(nnz, dtype=torch.int32, device=flat.device)
    return packbits_le(mask), q, cvals, cidx, count, residual


def _gather_support(mask_bytes, cvals, n, dtype):
    bits = unpackbits_le(mask_bytes, n)
    pos = torch.cumsum(bits.to(torch.int64), 0) - 1
    cap = max(cvals.numel(), 1)
    src = cvals if cvals.numel() else torch.zeros(1, dtype=cvals.dtype,
                                                  device=cvals.device)
    vals = src[pos.clamp(0, cap - 1)].to(dtype)
    return bits, vals


def wire_unpack_add_ref(
    target: torch.Tensor, mask_bytes: torch.Tensor, cvals: torch.Tensor
) -> torch.Tensor:
    """``target + decoded``, adding ``+0`` off the support (so ``-0.0`` in
    the target turns into ``+0.0``, as numpy's ``target + decoded`` does)."""
    bits, vals = _gather_support(mask_bytes, cvals, target.numel(),
                                 target.dtype)
    zero = torch.zeros((), dtype=target.dtype, device=target.device)
    return target + torch.where(bits, vals, zero)


def wire_unpack_ref(
    mask_bytes: torch.Tensor, cvals: torch.Tensor, n: int, dtype: torch.dtype
) -> torch.Tensor:
    """Decode only: the values on the support, zeros elsewhere."""
    bits, vals = _gather_support(mask_bytes, cvals, n, dtype)
    zero = torch.zeros((), dtype=dtype, device=mask_bytes.device)
    return torch.where(bits, vals, zero)

"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes and is the ground
truth the kernel is held to on the card (``chip_smoke.py``: bit for bit for
B1-B6, at stated tolerances for the float32 sums of B7 and B8) and against
the JAX package on the CPU (``tests/test_torch_*.py``). A wrapper takes its plain version only
for a tensor that lies on the CPU; nothing on the CUDA path calls these.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

_BIT = torch.arange(8, dtype=torch.uint8)


def significance_ref(
    u: torch.Tensor, x: torch.Tensor, r: torch.Tensor, v_t: float,
    floor: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """acc = f32(r) + f32(u); split by |acc| > v_t * max(|f32(x)|, floor)
    -> (sig in u's dtype, res in r's dtype, each rounded to nearest even).

    float32, float16 or bfloat16, as the TPU kernel's body computes it;
    ``x`` may lack ``u``'s leading dimensions (it is broadcast)."""
    acc = r.float() + u.float()
    f = torch.tensor(floor, dtype=torch.float32, device=x.device)
    denom = torch.maximum(x.float().abs(), f)
    vt = torch.tensor(v_t, dtype=torch.float32, device=x.device)
    mask = acc.abs() > vt * denom
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    return (torch.where(mask, acc, zero).to(u.dtype),
            torch.where(mask, zero, acc).to(r.dtype))


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


def wire_nnz_ref(flat: torch.Tensor) -> torch.Tensor:
    """The count of ``flat != 0`` as a 0-d int32 tensor (``-0.0`` is zero,
    NaN is not)."""
    return torch.sum(flat != 0, dtype=torch.int32)


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


# -- fused Adam (B3) and fused Adam + significance (B2) --------------------------


class AdamScalars(NamedTuple):
    """The host-side scalar block of B2/B3, every entry a float32 value.

    ``lr, b1, b2, eps, bc1, bc2, last`` are the TPU kernel's (1, 8) block
    (``last`` is ``v_t`` for B2, the weight decay for B3); ``scale`` sits in
    the slot the TPU kernel leaves at 0 and is the ``1/P_active`` factor B2
    applies to ``u``; ``omb1 = 1 - b1`` and ``omb2 = 1 - b2`` are rounded
    once from double, as the JAX package's ``adam_ref`` and ``optim.adam``
    round them.
    """

    lr: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float
    last: float
    scale: float
    omb1: float
    omb2: float


@functools.lru_cache(maxsize=64)
def adam_scalars(lr, b1: float, b2: float, eps: float, step, last=0.0,
                 scale=1.0) -> AdamScalars:
    """The scalar block for Adam at 1-indexed ``step``: bias corrections
    ``1 - b^t`` in float32, as ``repro.kernels.fused_adam._scalars``
    computes them. Cached: the leaves of one step share one block."""
    f = np.float32
    t = np.maximum(f(step), f(1.0))
    bc1 = f(1.0) - np.power(f(b1), t)
    bc2 = f(1.0) - np.power(f(b2), t)
    vals = (f(lr), f(b1), f(b2), f(eps), bc1, bc2, f(last), f(scale),
            f(1.0 - b1), f(1.0 - b2))
    return AdamScalars(*(float(v) for v in vals))


def _adam_core(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               s: AdamScalars):
    """``(mu', nu', step)`` in float32, one rounding per operation.

    The divisors are 0-d tensors on the data's device: PyTorch on CUDA
    divides by a Python scalar as a multiply by its reciprocal, which is
    not the rounded quotient the kernel computes.
    """
    dev = g.device
    bc1 = torch.tensor(s.bc1, dtype=torch.float32, device=dev)
    bc2 = torch.tensor(s.bc2, dtype=torch.float32, device=dev)
    gf = g.to(torch.float32)
    mu2 = s.b1 * mu.to(torch.float32) + s.omb1 * gf
    nu2 = s.b2 * nu.to(torch.float32) + s.omb2 * (gf * gf)
    upd = -s.lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + s.eps)
    return mu2, nu2, upd


def adam_ref(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
             nu: torch.Tensor, s: AdamScalars):
    """One Adam update with decoupled weight decay ``s.last``; returns
    ``(new_p, new_mu, new_nu)`` (``repro.kernels.ref.adam_ref``), computed
    in float32 and each rounded to its input's dtype."""
    mu2, nu2, upd = _adam_core(g, mu, nu, s)
    pf = p.to(torch.float32)
    if s.last:
        lr_wd = float(np.float32(s.lr) * np.float32(s.last))
        upd = upd - lr_wd * pf
    return (pf + upd).to(p.dtype), mu2.to(mu.dtype), nu2.to(nu.dtype)


def adam_sig_ref(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, r: torch.Tensor, s: AdamScalars,
                 floor: float = 1e-8):
    """Adam update -> ``u * s.scale`` -> residual accumulate -> split at
    ``v_t = s.last``; returns ``(sig, new_mu, new_nu, new_residual, u)``
    (``repro.kernels.ref.adam_sig_ref`` plus the scaled update ``u``,
    which the worker applies locally). Computed in float32; ``sig`` and
    ``u`` are rounded to ``p``'s dtype, the moments to theirs and the
    residual to ``r``'s, as the TPU kernel writes each output."""
    mu2, nu2, upd = _adam_core(g, mu, nu, s)
    u = upd * s.scale
    sig, res = significance_ref(u, p, r, s.last, floor)
    return (sig.to(p.dtype), mu2.to(mu.dtype), nu2.to(nu.dtype), res,
            u.to(p.dtype))


# -- flash attention (B7) ------------------------------------------------------

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window=None, q_offset: int = 0
            ) -> torch.Tensor:
    """Dense masked attention in float32 (``repro.kernels.ref.mha_ref``).

    q (B, Sq, H, Dh), k and v (B, Skv, K, Dh) with H a multiple of K: query
    head h reads KV head h // (H / K). Masked logits are -1e30, so a row
    with no allowed key averages v as the JAX reference does. Output in
    ``q.dtype``.
    """
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qg = q.float().reshape(b, sq, kh, h // kh, dh)
    logits = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    allow = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= k_pos <= q_pos
    if window is not None:
        allow &= q_pos - k_pos < window
    logits = torch.where(allow, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


# -- sLSTM scan (B8) -----------------------------------------------------------


def slstm_cell(r: torch.Tensor, xg: torch.Tensor, state):
    """One sLSTM step (``repro.models.xlstm._slstm_cell``): ``xg`` (B, 4d)
    input gates, ``r`` (H, dh, 4dh) float32 recurrent weights, ``state``
    ``(c, n, h)`` each (B, d) float32. Returns ``((c', n', h'), h')``."""
    c, n, h = state
    b, d = c.shape
    hh = r.shape[0]
    dh = d // hh
    rh = torch.einsum("bhd,hde->bhe", h.reshape(b, hh, dh), r)
    # per-head gates contiguous -> the fused (i | f | z | o) layout of w_in
    rh = rh.reshape(b, hh, 4, dh).transpose(1, 2).reshape(b, 4 * d)
    g = xg + rh
    i = torch.exp(torch.clamp(g[:, 0 * d:1 * d], max=8.0))
    f = torch.sigmoid(g[:, 1 * d:2 * d])
    z = torch.tanh(g[:, 2 * d:3 * d])
    o = torch.sigmoid(g[:, 3 * d:4 * d])
    c1 = f * c + i * z
    n1 = f * n + i
    h1 = o * (c1 / torch.clamp(n1.abs(), min=1.0))
    return (c1, n1, h1), h1


def slstm_scan_ref(xg: torch.Tensor, r: torch.Tensor, state=None):
    """The sequential scan of ``slstm_cell`` over ``xg`` (B, S, 4d) float32
    from ``state`` (zeros when None); returns ``(h (B, S, d), (c, n, h))``."""
    b, s, four_d = xg.shape
    d = four_d // 4
    if state is None:
        state = tuple(torch.zeros(b, d, dtype=torch.float32,
                                  device=xg.device) for _ in range(3))
    rf = r.float()
    hs = []
    for t in range(s):
        state, h = slstm_cell(rf, xg[:, t], state)
        hs.append(h)
    out = (torch.stack(hs, 1) if hs else
           torch.zeros(b, 0, d, dtype=torch.float32, device=xg.device))
    return out, tuple(state)

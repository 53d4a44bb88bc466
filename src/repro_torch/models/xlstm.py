"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

The port of ``repro.models.xlstm``. mLSTM runs its chunkwise-parallel
form in plain PyTorch (the JAX package has no kernel for it either):

    C_t = f_t * C_{t-1} + i_t * (v_t k_t^T)     # (Dh, Dh) matrix memory
    n_t = f_t * n_{t-1} + i_t * k_t             # normalizer
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

with sigmoid input gates, as in the JAX package. sLSTM has recurrent
h_{t-1} -> gate connections and is sequential: its prefill runs B8
(``kernels.slstm_scan``) on the card, one launch per block over the whole
prompt, from and into the decode cache; its decode step is the plain cell,
as in JAX. Both blocks carry xLSTM's internal up/down projections (d_ff =
0: there is no separate FF block). Caches are updated in place.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import slstm_cell
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import gelu, pdt
from repro_torch.models.params import ParamDef

PyTree = Any

_CHUNK = 256


def _inner(cfg: ArchConfig) -> int:
    return int(cfg.d_model * cfg.lstm_proj_factor)


def _scale(dh: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _write(cache: Optional[PyTree], new: dict) -> Optional[PyTree]:
    """Copy the new state into ``cache`` in place; returns the cache."""
    if cache is not None:
        for key, val in new.items():
            cache[key].copy_(val)
    return cache


# ---------------------------------------------------------------- mLSTM ------


def mlstm_defs(cfg: ArchConfig) -> PyTree:
    d, di, h = cfg.d_model, _inner(cfg), cfg.n_heads
    dt = pdt(cfg)
    return {
        "w_up": ParamDef((d, di), dt),
        "w_gate": ParamDef((d, di), dt),
        "wq": ParamDef((di, di), dt),
        "wk": ParamDef((di, di), dt),
        "wv": ParamDef((di, di), dt),
        "w_if": ParamDef((di, 2 * h), torch.float32),
        "b_if": ParamDef((2 * h,), torch.float32, "zeros"),
        "w_down": ParamDef((di, d), dt),
    }


def mlstm_cache_defs(cfg: ArchConfig, batch: int) -> PyTree:
    h = cfg.n_heads
    dh = _inner(cfg) // h
    return {"C": ParamDef((batch, h, dh, dh), torch.float32, "zeros"),
            "n": ParamDef((batch, h, dh), torch.float32, "zeros")}


def _mlstm_chunk(q, k, v, log_f, i_gate, C0, n0):
    """One chunk of the chunkwise-parallel mLSTM.

    q/k/v: (B, H, c, Dh); log_f, i_gate: (B, H, c); C0: (B, H, Dh, Dh);
    n0: (B, H, Dh). Returns (h, C1, n1).
    """
    c, dh = q.shape[2], q.shape[3]
    L = torch.cumsum(log_f, dim=-1)  # (B,H,c) cumulative log decay
    # intra-chunk: D[t,s] = exp(L_t - L_s) * i_s  for s <= t
    diff = L[..., :, None] - L[..., None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri, torch.exp(diff), torch.zeros((), device=q.device))
    D = D * i_gate[..., None, :]
    scale = _scale(dh)
    att = (q @ k.transpose(-1, -2)) * scale * D  # (B,H,c,c)
    intra = att @ v
    # inter-chunk: h_t += exp(L_t) * (q_t C0), with C0 in k (x) v layout
    decay_t = torch.exp(L)[..., None]
    inter = (q @ C0) * scale * decay_t
    num = intra + inter
    intra_den = att.sum(-1, keepdim=True)
    inter_den = (q @ n0[..., None]) * scale * decay_t
    den = (intra_den + inter_den).abs()
    h = num / torch.clamp(den, min=1.0)
    # state update: C1 = exp(L_c) C0 + sum_s exp(L_c - L_s) i_s k_s v_s^T
    w = torch.exp(L[..., -1:] - L) * i_gate  # (B,H,c)
    last = torch.exp(L[..., -1])
    C1 = last[..., None, None] * C0 + torch.einsum("bhc,bhcd,bhce->bhde",
                                                   w, k, v)
    n1 = last[..., None] * n0 + torch.einsum("bhc,bhcd->bhd", w, k)
    return h, C1, n1


def mlstm_apply(cfg: ArchConfig, p: PyTree, x: torch.Tensor,
                cache: Optional[PyTree] = None, decode: bool = False
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    """x: (B, S, d) -> (out, cache)."""
    b, s, _ = x.shape
    h, di = cfg.n_heads, _inner(cfg)
    dh = di // h
    up = x @ p["w_up"].to(x.dtype)  # (B,S,di)
    gate = F.silu(x @ p["w_gate"].to(x.dtype))

    def heads(m):
        return m.reshape(b, -1, h, dh).transpose(1, 2).float()

    q = heads(up @ p["wq"].to(x.dtype))
    k = heads(up @ p["wk"].to(x.dtype))
    v = heads(up @ p["wv"].to(x.dtype))
    gates = up.float() @ p["w_if"] + p["b_if"]  # (B,S,2H)
    gates = gates.reshape(b, s, 2, h).transpose(1, 3)  # (B,H,2,S)
    i_gate = torch.sigmoid(gates[:, :, 0])  # (B,H,S)
    log_f = F.logsigmoid(gates[:, :, 1])

    if decode:
        if cache is None or s != 1:
            raise ValueError("mLSTM decode takes one token and a cache")
        f1 = torch.exp(log_f[..., 0])[..., None, None]
        ig = i_gate[..., 0]
        # k (x) v state layout, as in the chunkwise-parallel form
        C1 = f1 * cache["C"] + ig[..., None, None] * (
            k[:, :, 0, :, None] @ v[:, :, 0, None, :])
        n1 = f1[..., 0] * cache["n"] + ig[..., None] * k[:, :, 0]
        scale = _scale(dh)
        num = torch.einsum("bhd,bhde->bhe", q[:, :, 0], C1) * scale
        den = (n1 * q[:, :, 0]).sum(-1, keepdim=True).abs() * scale
        hv = (num / torch.clamp(den, min=1.0))[:, :, None, :]  # (B,H,1,Dh)
    else:
        c = min(_CHUNK, s)
        if s % c:
            raise ValueError(f"mLSTM prefill length {s} is not a multiple "
                             f"of its chunk {c}")
        if cache is not None:
            C1, n1 = cache["C"], cache["n"]
        else:
            C1 = torch.zeros(b, h, dh, dh, device=x.device)
            n1 = torch.zeros(b, h, dh, device=x.device)
        outs = []
        for j in range(0, s, c):
            sl = slice(j, j + c)
            hc, C1, n1 = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                      log_f[..., sl], i_gate[..., sl], C1, n1)
            outs.append(hc)
        hv = torch.cat(outs, 2)
    cache = _write(cache, {"C": C1, "n": n1})
    merged = hv.transpose(1, 2).reshape(b, -1, di).to(x.dtype)
    out = (gate * merged) @ p["w_down"].to(x.dtype)
    return out.to(x.dtype), cache


# ---------------------------------------------------------------- sLSTM ------


def _slstm_up(d: int) -> int:
    """xLSTM's 4/3 FF expansion rounded to a multiple of 256."""
    return ((int(d * 4 / 3) + 255) // 256) * 256


def slstm_defs(cfg: ArchConfig) -> PyTree:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = pdt(cfg)
    return {
        # input -> 4 gates (i, f, z, o), fused
        "w_in": ParamDef((d, 4 * d), dt),
        "b_in": ParamDef((4 * d,), torch.float32, "zeros"),
        # recurrent h_{t-1} -> gates, block-diagonal per head
        "r": ParamDef((h, dh, 4 * dh), dt, init_scale=0.5),
        "w_up": ParamDef((d, _slstm_up(d)), dt),
        "w_down": ParamDef((_slstm_up(d), d), dt),
    }


def slstm_cache_defs(cfg: ArchConfig, batch: int) -> PyTree:
    d = cfg.d_model
    return {key: ParamDef((batch, d), torch.float32, "zeros")
            for key in ("c", "n", "h")}


def _slstm_cell(p: PyTree, xg: torch.Tensor, state):
    """One timestep. xg: (B, 4d) pre-computed input projection."""
    return slstm_cell(p["r"].float(), xg, state)


def slstm_apply(cfg: ArchConfig, p: PyTree, x: torch.Tensor,
                cache: Optional[PyTree] = None, decode: bool = False
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    b, s, d = x.shape
    xg = (x @ p["w_in"].to(x.dtype)).float() + p["b_in"]
    state = None
    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"])
    if decode:
        if cache is None or s != 1:
            raise ValueError("sLSTM decode takes one token and a cache")
        state, h = _slstm_cell(p, xg[:, 0], state)
        hs = h[:, None, :]
    else:
        hs, state = slstm_scan(xg, p["r"], state)
    cache = _write(cache, dict(zip(("c", "n", "h"), state)))
    up = gelu(hs.to(x.dtype) @ p["w_up"].to(x.dtype))
    out = up @ p["w_down"].to(x.dtype)
    return out.to(x.dtype), cache

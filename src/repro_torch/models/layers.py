"""Layer primitives: norms, MLPs, embeddings, RoPE and the chunked
cross-entropy loss (``repro.models.layers``).

Every layer exposes ``<layer>_defs(cfg, ...) -> ParamDef tree`` and
``<layer>_apply(cfg, params, x, ...) -> y``. Activations flow in
``cfg.activation_dtype`` (bf16 by default); normalisation statistics,
softmax and RoPE angles are float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig, FF
from repro_torch.models.params import ParamDef

PyTree = Any


def dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def adt(cfg: ArchConfig) -> torch.dtype:
    return dtype(cfg.activation_dtype)


def pdt(cfg: ArchConfig) -> torch.dtype:
    return dtype(cfg.param_dtype)


# ---- normalization -----------------------------------------------------------


def norm_defs(cfg: ArchConfig, d: Optional[int] = None) -> PyTree:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), pdt(cfg), "ones"),
                "bias": ParamDef((d,), pdt(cfg), "zeros")}
    return {"scale": ParamDef((d,), pdt(cfg), "ones")}


def norm_apply(cfg: ArchConfig, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ---- feed-forward -------------------------------------------------------------


def ff_defs(cfg: ArchConfig, kind: FF) -> PyTree:
    d, f = cfg.d_model, cfg.d_ff
    dt = pdt(cfg)
    if kind in (FF.SWIGLU, FF.GEGLU):
        return {"w_gate": ParamDef((d, f), dt), "w_up": ParamDef((d, f), dt),
                "w_down": ParamDef((f, d), dt)}
    if kind is FF.GELU:
        return {"w_up": ParamDef((d, f), dt),
                "b_up": ParamDef((f,), dt, "zeros"),
                "w_down": ParamDef((f, d), dt),
                "b_down": ParamDef((d,), dt, "zeros")}
    raise ValueError(f"ff_defs: {kind} is not a dense FF (MoE is "
                     f"models.moe.moe_defs)")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ff_apply(cfg: ArchConfig, kind: FF, p: PyTree,
             x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model)."""
    if kind in (FF.SWIGLU, FF.GEGLU):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        act = F.silu(g) if kind is FF.SWIGLU else gelu(g)
        return ((act * u) @ p["w_down"]).to(x.dtype)
    if kind is FF.GELU:
        h = gelu(x @ p["w_up"] + p["b_up"].to(x.dtype))
        return (h @ p["w_down"] + p["b_down"].to(x.dtype)).to(x.dtype)
    raise ValueError(f"ff_apply: {kind} is not a dense FF (MoE is "
                     f"models.moe.moe_apply)")


# ---- embeddings ----------------------------------------------------------------


def embed_defs(cfg: ArchConfig) -> PyTree:
    defs = {"tok": ParamDef((cfg.padded_vocab, cfg.d_model), pdt(cfg))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab), pdt(cfg))
    return defs


def embed_apply(cfg: ArchConfig, p: PyTree,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d_model)."""
    x = p["tok"][tokens.long()].to(adt(cfg))
    # gemma-style sqrt(d) scaling: the float32 sqrt rounded to the activation
    # type on the host (a device tensor made from a host scalar would wait
    # for the card)
    s = torch.tensor(float(np.sqrt(np.float32(cfg.d_model))), dtype=adt(cfg))
    return x * float(s)


def unembed_apply(cfg: ArchConfig, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_model) -> logits (..., padded vocab) in float32."""
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return (x @ w.to(x.dtype)).float()


# ---- rotary position embeddings -------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Rotates the pairs
    ``(x[..., i], x[..., i + Dh/2])`` by float32 angles."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(base, exps)  # float32
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# ---- losses ---------------------------------------------------------------------


def chunked_softmax_xent(cfg: ArchConfig, embed_params: PyTree,
                         hidden: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy over sequence chunks, in float32.

    Each chunk computes logits (in the activation type, then float32), a
    logsumexp and the label's logit, as the JAX package does; padded
    vocabulary columns get a -1e30 bias so they stay out of the
    normaliser. The JAX package rematerialises each chunk in the backward
    pass; at the port's training shapes one chunk's logits fit, so
    autograd keeps them.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    dev = hidden.device
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    col_valid = (torch.arange(cfg.padded_vocab, device=dev)
                 < cfg.vocab_size).float()
    col_bias = (1.0 - col_valid) * -1e30
    w = embed_params.get("unembed")
    if w is None:
        w = embed_params["tok"].T

    def chunk_loss(h_c, y_c, m_c):
        logits = (h_c @ w.to(h_c.dtype)).float() + col_bias
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, y_c.long()[..., None])[..., 0]
        return torch.sum((lse - lab) * m_c), torch.sum(m_c)

    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:  # the remainder, one shorter chunk
        bounds.append((n_chunks * chunk, s))
    for lo, hi in bounds:
        loss, n = chunk_loss(hidden[:, lo:hi], labels[:, lo:hi],
                             mask[:, lo:hi].float())
        tot, cnt = tot + loss, cnt + n
    return tot / torch.maximum(cnt, torch.ones_like(cnt))

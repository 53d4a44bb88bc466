"""Attention: GQA + RoPE, global causal or sliding-window
(``repro.models.attention``).

Two paths, as in the JAX package:

* prefill (and a training forward): the whole sequence through B7
  (``kernels.flash_attention``) for every prompt length, with the layer's
  window for a sliding-window layer, K/V written into the cache in the
  GQA layout first. The JAX package picks a dense, chunked or banded XLA
  core by length; the port needs none of them.
* decode: one query against the cache through the plain ``_dense_core``,
  an einsum outside any kernel in JAX too.

A sliding-window layer's cache is a ring of ``min(max_len, window)``
positions: position ``p`` lives in slot ``p % L``. Prefill keeps the last
``L`` positions of a longer prompt there; decode writes its slot and
rebuilds each slot's position from ``decode_pos``.

Softmax math is float32 regardless of the activation type. Caches are
updated in place (the JAX package returns new arrays): a decode step
writes one position of each layer's cache instead of copying it. Cross
attention and prefix-LM masks are not ported (ROADMAP.md §A3).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ArchConfig, BlockSpec, Mixer
from repro_torch.models.layers import adt, pdt, rope
from repro_torch.models.params import ParamDef

PyTree = Any


def _refuse(spec: BlockSpec) -> None:
    if spec.mixer not in (Mixer.GLOBAL_ATTN, Mixer.LOCAL_ATTN):
        raise NotImplementedError(
            f"{spec.mixer.value}: only global and sliding-window attention "
            f"are ported (ROADMAP.md §A3: cross attention is still to port)")


# ---- params -------------------------------------------------------------------


def attn_defs(cfg: ArchConfig) -> PyTree:
    """Projection params in the JAX package's flat (d, H*Dh) layout."""
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = pdt(cfg)
    defs = {
        "wq": ParamDef((d, h * dh), dt),
        "wk": ParamDef((d, k * dh), dt),
        "wv": ParamDef((d, k * dh), dt),
        "wo": ParamDef((h * dh, d), dt),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * dh,), dt, "zeros")
        defs["bk"] = ParamDef((k * dh,), dt, "zeros")
        defs["bv"] = ParamDef((k * dh,), dt, "zeros")
    return defs


def cache_defs(cfg: ArchConfig, spec: BlockSpec, batch: int,
               max_len: int) -> PyTree:
    """KV-cache defs for one attention block: flat (B, L, K*Dh), L the
    ring's ``min(max_len, window)`` for a sliding-window layer."""
    _refuse(spec)
    kd = cfg.n_kv_heads * cfg.resolved_head_dim
    length = (min(max_len, spec.window) if spec.mixer is Mixer.LOCAL_ATTN
              else max_len)
    return {"k": ParamDef((batch, length, kd), adt(cfg), "zeros"),
            "v": ParamDef((batch, length, kd), adt(cfg), "zeros")}


# ---- masks and the dense core ----------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int] = None,
          k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Sq, Skv) boolean allow-mask."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (qp - kp < window)
    if k_valid is not None:
        m = m & k_valid[None, :]
    return m


def _dense_core(q, kv_k, kv_v, mask) -> torch.Tensor:
    """q (B,Sq,K,G,Dh), k/v (B,Skv,K,Dh), mask (Sq,Skv) -> (B,Sq,K,G,Dh)."""
    dh = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    logits = torch.einsum("bqkgd,bckd->bqkgc", q.float(), kv_k.float()) * scale
    logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", probs, kv_v.float())
    return out.to(q.dtype)


# ---- block application ------------------------------------------------------------


def _project_qkv(cfg: ArchConfig, p: PyTree, x: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,K,Dh). Weights are flat."""
    h, k_heads, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    b, s = x.shape[0], x.shape[1]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, k_heads, dh),
            v.reshape(b, s, k_heads, dh))


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def _ungroup(o: torch.Tensor) -> torch.Tensor:
    b, s, k, g, dh = o.shape
    return o.reshape(b, s, k * g, dh)


def attn_apply(
    cfg: ArchConfig,
    spec: BlockSpec,
    p: PyTree,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[PyTree] = None,
    decode_pos: Optional[int] = None,
    causal: bool = True,
) -> tuple[torch.Tensor, Optional[PyTree]]:
    """One attention block; returns ``(out, cache)``.

    * prefill / training forward (``decode_pos`` is None): x is the whole
      sequence; with a cache, K/V fill its first positions (in place), or
      a ring's slots ``p % L`` with the last ``L`` positions.
    * decode: x is (B, 1, D) at position ``decode_pos``; K/V are written
      there (in place; slot ``decode_pos % L`` of a ring) and the query
      attends over the cache.
    """
    _refuse(spec)
    b, s, _ = x.shape
    n_kv = cfg.n_kv_heads
    window = spec.window if spec.mixer is Mixer.LOCAL_ATTN else None
    if positions is None:
        base = 0 if decode_pos is None else decode_pos
        positions = (base + torch.arange(s, device=x.device))[None, :].expand(
            b, s)

    q, k, v = _project_qkv(cfg, p, x)
    if spec.rope_base is not None:
        q = rope(q, positions, spec.rope_base)
        k = rope(k, positions, spec.rope_base)

    def _flat(t):  # (B, L, K, Dh) -> cache layout (B, L, K*Dh)
        return t.reshape(t.shape[0], t.shape[1], -1)

    def _unflat(t):  # cache layout -> (B, L, K, Dh)
        return t.reshape(t.shape[0], t.shape[1], n_kv, cfg.resolved_head_dim)

    if decode_pos is not None:
        if cache is None:
            raise ValueError("decode needs a cache")
        length = cache["k"].shape[1]
        slot = decode_pos % length if window is not None else decode_pos
        cache["k"][:, slot:slot + s] = _flat(k)
        cache["v"][:, slot:slot + s] = _flat(v)
        idx = torch.arange(length, device=x.device)
        if window is not None:
            # slot i holds position decode_pos - ((decode_pos - i) mod L)
            k_pos = decode_pos - torch.remainder(decode_pos - idx, length)
            k_valid = k_pos >= 0
        else:
            k_pos, k_valid = idx, idx <= decode_pos
        allow = _mask(positions[0], k_pos, causal, window, k_valid)
        out = _ungroup(_dense_core(_group(q, n_kv), _unflat(cache["k"]),
                                   _unflat(cache["v"]), allow))
    else:
        if cache is not None:  # prefill: persist K/V (GQA layout)
            length = cache["k"].shape[1]
            if window is not None and s > length:
                # the ring keeps the last L positions, position p at p % L
                slots = torch.remainder(
                    torch.arange(s - length, s, device=x.device), length)
                cache["k"][:, slots] = _flat(k)[:, -length:]
                cache["v"][:, slots] = _flat(v)[:, -length:]
            else:
                n = min(s, length)
                cache["k"][:, :n] = _flat(k)[:, :n]
                cache["v"][:, :n] = _flat(v)[:, :n]
        out = ops.flash_attention(q, k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)

    y = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return y.to(x.dtype), cache


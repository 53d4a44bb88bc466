"""Mixture-of-Experts feed-forward: top-k routing and capacity-based
dispatch (``repro.models.moe``), on one card.

Dispatch is the cumsum/scatter formulation (no sort of the tokens): each
(token, k) assignment takes the next slot of its expert's capacity buffer
in token-major arrival order (an exclusive cumulative sum over one-hot
expert indicators), an assignment past the capacity is dropped, the kept
ones are scattered into an (E', C, d) buffer, the experts' SwiGLU runs as
three grouped products, and the outputs are gathered back with the
renormalised gate weights.

Parameters keep the JAX package's virtual-expert layout: when the expert
count does not fill ``EP_TARGET``, each physical expert is split into
``expert_split`` f-slices that share its routing decision (SwiGLU and the
down projection are f-separable), so the leaves are ``(E*split, d,
f/split)`` and ``(E*split, f/split, d)`` and cross between the packages
unchanged (``convert.from_leaves``). The JAX package's multi-device
dispatch (token groups, ``shard_map``, the expert all-to-all) has no
counterpart: the port runs one group on one card (ROADMAP.md §A4).

No Pallas kernel computes this in the JAX package: routing, scatter and
gather are plain PyTorch operations and the grouped products ``bmm``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import pdt
from repro_torch.models.params import ParamDef

PyTree = Any

EP_TARGET = 16  # the JAX package's expert-parallel axis size


def expert_split(cfg: ArchConfig) -> int:
    """f-dim split factor turning E physical experts into E*split virtual
    experts (mixtral: 8 experts x 2)."""
    e = cfg.moe.n_experts
    if e % EP_TARGET == 0:
        return 1
    assert EP_TARGET % e == 0, (e, EP_TARGET)
    return EP_TARGET // e


def moe_defs(cfg: ArchConfig) -> PyTree:
    """The float32 router (d, E) and the expert weights in the
    virtual-expert layout."""
    assert cfg.moe is not None
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    s = expert_split(cfg)
    dt = pdt(cfg)
    return {
        "router": ParamDef((d, e), torch.float32),
        "w_gate": ParamDef((e * s, d, f // s), dt),
        "w_up": ParamDef((e * s, d, f // s), dt),
        "w_down": ParamDef((e * s, f // s, d), dt),
    }


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: ``ceil(n * k * factor / E)``, at least 8, rounded
    up to a multiple of 8."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values, largest
    first, the lower index first among equal values (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ArchConfig, p: PyTree, xt: torch.Tensor):
    """Float32 routing of tokens ``xt`` (n, d): ``(probs (n, E), gates
    (n, k) renormalised to sum 1, expert ids (n, k))``."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = top_k(probs, cfg.moe.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, ids


def slots(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k) assignment's place in its expert's buffer, in
    token-major arrival order (an exclusive cumulative sum): (n * k,)."""
    onehot = F.one_hot(ids.reshape(-1), n_experts)
    return ((onehot.cumsum(0) - onehot) * onehot).sum(-1)


def moe_apply(cfg: ArchConfig, p: PyTree,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ``(out (B, S, d), aux)``; ``aux`` is the Switch
    load-balance term, ``E * sum(density / k * mean_prob)``, float32."""
    m = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, m.n_experts, m.top_k
    dev = x.device
    xt = x.reshape(n, d)
    probs, gates, ids = route(cfg, p, xt)

    # load balance: the share of (token, k) assignments per expert against
    # the mean routing probability
    density = F.one_hot(ids, e).float().sum(1).mean(0)
    aux = e * torch.sum(density / k * probs.mean(0))

    # capacity slots: each assignment's place in its physical expert, in
    # token-major (token, k) order; past the capacity it is dropped
    c = capacity(n, cfg)
    flat_e = ids.reshape(n * k)
    slot = slots(ids, e)
    keep = slot < c

    # virtual experts: an assignment fans out to its expert's `split`
    # f-slices, the same slot in each
    split = expert_split(cfg)
    tok_idx = torch.arange(n, device=dev).repeat_interleave(k * split)
    flat_ev = (flat_e[:, None] * split
               + torch.arange(split, device=dev)[None, :]).reshape(-1)
    keep_v = keep.repeat_interleave(split)
    safe_slot = torch.where(keep_v, slot.repeat_interleave(split), c - 1)
    w_assign = (gates.reshape(-1) * keep.float()).repeat_interleave(split)

    # dispatch: a dropped assignment adds zeros to its expert's last slot
    contrib = torch.where(keep_v[:, None], xt[tok_idx], 0)
    buf = torch.zeros((e * split, c, d), dtype=x.dtype, device=dev)
    buf.index_put_((flat_ev, safe_slot), contrib, accumulate=True)

    # the experts' SwiGLU, whatever spec.ff says (as in the JAX package)
    gg = torch.bmm(buf, p["w_gate"].to(x.dtype))
    uu = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = (F.silu(gg) * uu).to(x.dtype)
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype))

    # combine: each assignment's output times its gate (0 when dropped)
    gathered = out_buf[flat_ev, safe_slot]
    weighted = gathered * w_assign[:, None].to(x.dtype)
    out = weighted.reshape(n, k * split, d).sum(1)
    return out.reshape(b, s, d), aux

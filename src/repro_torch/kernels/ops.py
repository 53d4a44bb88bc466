"""Tree-level entry points of the port's kernels.

``significance_tree`` is the ISP filter of the worker's Nesterov and SGD
steps: B1 on every leaf. ``flash_attention`` is B7 on (B, S, H, Dh)
tensors. ``adam_isp_tree`` is the worker's whole Adam + ISP
step: B2 on every leaf, and with scale 1 the in-process trainer's
``isp`` Adam step; ``adam_tree`` is its ``bsp`` Adam step: B3 on every
leaf.
``sent_fraction`` is the communicated share of an ISP step: B6 on every
leaf. ``fused_adam`` and ``fused_adam_sig`` apply B3 and B2 leaf by leaf over
trees of one structure (a single tensor is a tree of one leaf). Each runs
the kernel for CUDA leaves and its plain version for CPU leaves.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.fused_adam import adam_sig_update, adam_update
from repro_torch.kernels.significance import significance_filter
from repro_torch.kernels.wire_pack import wire_nnz

PyTree = Any


def _unzip(like: PyTree, outs: list, k: int) -> tuple:
    return tuple(tree_lib.unflatten(like, [o[i] for o in outs])
                 for i in range(k))


def significance_tree(updates: PyTree, params: PyTree, residual: PyTree,
                      v_t: float, floor: float = 1e-8):
    """``(sig, new_residual)`` trees: the filter split of ``residual +
    updates`` against ``params``, leaf by leaf."""
    out = [
        significance_filter(u, x, r, v_t, floor)
        for u, x, r in zip(tree_lib.leaves(updates), tree_lib.leaves(params),
                           tree_lib.leaves(residual))
    ]
    return _unzip(params, out, 2)


def sent_fraction(sig: PyTree) -> torch.Tensor:
    """The share of entries with ``sig != 0`` as a 0-d float32 tensor
    (``core.isp.communicated_fraction`` of the JAX step's masks): B6
    counts each leaf's hits on the card (its plain version on the CPU), the
    counts add up as integers and the sum is divided once in float32, so
    nothing here waits for the card."""
    leaves = tree_lib.leaves(sig)
    dev = leaves[0].device
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    total = 0
    for x in leaves:
        if x.numel():
            hits = hits + wire_nnz(x.reshape(-1))
        total += x.numel()
    return hits.float() / torch.full((), max(float(total), 1.0),
                                     dtype=torch.float32, device=dev)


def flash_attention(q, k, v, causal: bool = True, window=None,
                    q_offset: int = 0):
    """(B, S, H, Dh) attention (``repro.kernels.ops.flash_attention``).

    k and v may carry fewer heads than q (GQA, never repeated) and nothing
    is padded: the kernel takes the true Dh and ragged lengths.
    """
    return flash.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)


def fused_adam(p, g, mu, nu, lr, step, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0):
    """``(new_p, new_mu, new_nu)`` trees: B3 on every leaf."""
    out = [adam_update(*xs, lr, step, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay)
           for xs in zip(*(tree_lib.leaves(t) for t in (p, g, mu, nu)))]
    return _unzip(p, out, 3)


def fused_adam_sig(p, g, mu, nu, r, lr, step, v_t, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8, floor: float = 1e-8,
                   scale: float = 1.0):
    """``(sig, new_mu, new_nu, new_residual, u)`` trees: B2 on every
    leaf."""
    out = [adam_sig_update(*xs, lr, step, v_t, b1=b1, b2=b2, eps=eps,
                           floor=floor, scale=scale)
           for xs in zip(*(tree_lib.leaves(t) for t in (p, g, mu, nu, r)))]
    return _unzip(p, out, 5)


def _adam_lr(hparams: dict, step: int) -> float:
    """``optim.adam``'s eta_t in float32: lr, over sqrt(t) with decay."""
    lr = np.float32(hparams["lr"])
    if hparams.get("lr_decay"):
        lr = lr / np.sqrt(np.maximum(np.float32(step), np.float32(1.0)))
    return float(lr)


def adam_tree(grads: PyTree, state, params: PyTree, hparams: dict,
              step: int):
    """The in-process trainer's BSP Adam step through B3: ``optim.adam``'s
    update (``hparams`` are its settings) applied to every leaf.

    Returns ``(new_params, new_state)``: the same ``OptState`` layout and
    step increment as ``optim.adam``, moments in their own dtype (a
    bfloat16 model keeps bfloat16 moments, as in the JAX package), so
    checkpoints cross. ``step`` is the host value of ``state.step``, so
    nothing here waits for the card.
    """
    from repro_torch.optim import OptState

    p, mu, nu = fused_adam(params, grads, state.mu, state.nu,
                           _adam_lr(hparams, step), step, b1=hparams["b1"],
                           b2=hparams["b2"], eps=hparams["eps"],
                           weight_decay=hparams.get("weight_decay", 0.0))
    return p, OptState(state.step + 1, mu, nu)


def adam_isp_tree(grads: PyTree, state, params: PyTree, residual: PyTree,
                  hparams: dict, step: int, v_t: float, scale: float,
                  floor: float = 1e-8):
    """The Adam + ISP step through B2: ``optim.adam``'s update (``hparams``
    are its settings) scaled by ``scale`` (the FaaS worker's
    ``1/P_active``; 1 in the in-process ``isp`` mode), accumulated into
    ``residual`` and split at ``v_t``.

    Returns ``(u, sig, new_residual, new_state)``: the same ``OptState``
    layout and step increment as ``optim.adam``, so checkpoints cross
    between the fused and the unfused path and the JAX package. ``step``
    is the host value of ``state.step``: the caller holds it, so nothing
    here waits for the card.
    """
    from repro_torch.optim import OptState

    if hparams.get("weight_decay"):
        raise ValueError("the fused Adam + ISP step has no weight decay")
    sig, mu, nu, res, u = fused_adam_sig(
        params, grads, state.mu, state.nu, residual, _adam_lr(hparams, step),
        step, v_t, b1=hparams["b1"], b2=hparams["b2"], eps=hparams["eps"],
        floor=floor, scale=float(np.float32(scale)))
    return u, sig, res, OptState(state.step + 1, mu, nu)

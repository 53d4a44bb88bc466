"""ISP — the MLLess significance filter, float32 math in PyTorch.

Port of ``repro.core.isp``: each worker adds its step's update to a local
residual and communicates only the entries that have become significant
relative to the current parameter value,

    |acc_i| > v_t * max(|x_i|, floor),   v_t = v / sqrt(t),

keeping the rest in the residual (error feedback). ``significance_split``
and ``filter_update`` are the plain tensor math, bit-exact against the JAX
package on float32; the worker's step reaches the same split through the
B1 kernel (``kernels.ops.significance_tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

PyTree = Any

_EPS = 1e-12  # the |x| = 0 guard of ``residual_relative_norm``


@dataclasses.dataclass(frozen=True)
class ISPConfig:
    """v: initial threshold (v = 0 is BSP); decay: v_t = v / sqrt(t);
    absolute_floor: |x| floor of the denominator."""

    v: float = 0.7
    decay: bool = True
    absolute_floor: float = 1e-8

    def threshold(self, step: int) -> float:
        """v_t at 1-indexed ``step``, rounded as float32 arithmetic rounds
        it (the value is exactly representable in float32)."""
        v = np.float32(self.v)
        if not self.decay:
            return float(v)
        t = np.maximum(np.float32(int(step)), np.float32(1.0))
        return float(v / np.sqrt(t))


class ISPState(NamedTuple):
    residual: PyTree
    step: int  # 1-indexed


def init_state(params: PyTree) -> ISPState:
    """Zero residual with the structure of ``params``, at step 1."""
    return ISPState(tree_lib.tree_map(torch.zeros_like, params), 1)


def significance_split(acc: torch.Tensor, x: torch.Tensor, v_t: float,
                       absolute_floor: float = 1e-8):
    """``(sig, res, mask)`` with ``sig + res == acc`` exactly.

    Typed as the JAX package types it: the floor is a weakly typed
    constant, so it takes ``x``'s dtype, and the float32 ``v_t`` promotes
    the product and the compare to float32 (no-ops on float32 leaves)."""
    floor = torch.tensor(absolute_floor, dtype=x.dtype, device=x.device)
    denom = torch.maximum(x.abs(), floor)
    vt = torch.tensor(v_t, dtype=torch.float32, device=x.device)
    mask = acc.abs().float() > vt * denom.float()
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    return torch.where(mask, acc, zero), torch.where(mask, zero, acc), mask


def filter_update(config: ISPConfig, state: ISPState, update: PyTree,
                  params: PyTree):
    """One filter step over a tree: ``(significant, new_state, masks)``."""
    v_t = config.threshold(state.step)
    out = [
        significance_split(r + u, x, v_t, config.absolute_floor)
        for u, x, r in zip(tree_lib.leaves(update), tree_lib.leaves(params),
                           tree_lib.leaves(state.residual))
    ]
    sig = tree_lib.unflatten(params, [o[0] for o in out])
    res = tree_lib.unflatten(params, [o[1] for o in out])
    masks = tree_lib.unflatten(params, [o[2] for o in out])
    return sig, ISPState(res, state.step + 1), masks


def communicated_fraction(masks: PyTree) -> float:
    """Fraction of parameters communicated. A mask tree, or a tree of the
    significant updates: ``mask == (sig != 0)`` holds exactly, because a
    true mask means ``|acc| > thr >= 0``."""
    hit = total = 0
    for m in tree_lib.leaves(masks):
        hit += int(torch.count_nonzero(m))
        total += m.numel()
    return float(np.float32(hit) / np.float32(max(total, 1)))


def communicated_bytes(masks: PyTree, bytes_per_entry: int = 8) -> float:
    """Bytes of a sparse (value + index) encoding of the significant
    entries: ``bytes_per_entry`` per hit, in float32 as the JAX package
    computes it. A mask tree or a tree of the significant updates, as
    ``communicated_fraction`` takes."""
    hit = sum(int(torch.count_nonzero(m)) for m in tree_lib.leaves(masks))
    return float(np.float32(hit) * np.float32(bytes_per_entry))


def dense_bytes(params: PyTree, bytes_per_entry: int = 4) -> float:
    """Bytes of a dense encoding of a full update (the BSP cost)."""
    return float(sum(x.numel() for x in tree_lib.leaves(params))
                 ) * bytes_per_entry


def residual_relative_norm(state: ISPState, params: PyTree) -> float:
    """``max_i |r_i| / max(|x_i|, 1e-12)`` over every leaf: the tightest
    per-parameter deviation bound the residual currently witnesses."""
    return max(float(torch.max(r.abs() / torch.clamp_min(x.abs(), _EPS)))
               for r, x in zip(tree_lib.leaves(state.residual),
                               tree_lib.leaves(params)))


def flush(state: ISPState):
    """Emit the whole residual and clear it (eviction hand-off)."""
    zeros = tree_lib.tree_map(torch.zeros_like, state.residual)
    return state.residual, ISPState(zeros, state.step)

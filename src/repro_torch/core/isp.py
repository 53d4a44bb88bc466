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


def significance_split(acc: torch.Tensor, x: torch.Tensor, v_t: float,
                       absolute_floor: float = 1e-8):
    """``(sig, res, mask)`` with ``sig + res == acc`` exactly."""
    floor = torch.tensor(absolute_floor, dtype=torch.float32, device=x.device)
    denom = torch.maximum(x.abs(), floor)
    vt = torch.tensor(v_t, dtype=torch.float32, device=x.device)
    mask = acc.abs() > vt * denom
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


def flush(state: ISPState):
    """Emit the whole residual and clear it (eviction hand-off)."""
    zeros = tree_lib.tree_map(torch.zeros_like, state.residual)
    return state.residual, ISPState(zeros, state.step)

"""Tree-level entry points of the port's kernels.

``significance_tree`` is the ISP filter the worker's step runs: B1 on every
leaf (the kernel for CUDA leaves, its plain version for CPU leaves).
"""

from __future__ import annotations

from typing import Any

from repro_torch import tree as tree_lib
from repro_torch.kernels.significance import significance_filter

PyTree = Any


def significance_tree(updates: PyTree, params: PyTree, residual: PyTree,
                      v_t: float, floor: float = 1e-8):
    """``(sig, new_residual)`` trees: the filter split of ``residual +
    updates`` against ``params``, leaf by leaf."""
    out = [
        significance_filter(u, x, r, v_t, floor)
        for u, x, r in zip(tree_lib.leaves(updates), tree_lib.leaves(params),
                           tree_lib.leaves(residual))
    ]
    return (tree_lib.unflatten(params, [o[0] for o in out]),
            tree_lib.unflatten(params, [o[1] for o in out]))

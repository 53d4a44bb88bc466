"""Eviction hand-off (port of ``repro.dist.elastic.reintegrate_into``).

The worker needs only the single-replica, mean-preserving pull of a
leaving peer's replica; the pod-path re-meshing of the JAX module is not
ported.
"""

from __future__ import annotations

from typing import Any

from repro_torch import tree as tree_lib

PyTree = Any


def reintegrate_into(own: PyTree, leaving: PyTree, pool_before) -> PyTree:
    """x' = x + (x_leaving - x) / P_old, leafwise (float32).

    Applied by every survivor, the pool-mean parameter vector is unchanged.
    """
    return tree_lib.tree_map(lambda x, l: x + (l - x) / pool_before,
                             own, leaving)

"""Carry the JAX package's state across to the port, and back.

Both packages flatten a tree in the same leaf order and name every leaf by
the same ``/``-joined path (``repro_torch.tree``), so state crosses as a
plain list of numpy leaves: ``jax.tree_util.tree_leaves(x)`` converted
with ``numpy.asarray`` on one side, ``from_leaves`` onto a port template
on the other. Params, optimizer state and ISP residual all cross this way.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.wire.codec import to_numpy, to_tensor

PyTree = Any


def from_leaves(like: PyTree, arrays: Sequence[Any],
                device: Any = "cpu") -> PyTree:
    """A port tree shaped like ``like`` holding copies of numpy ``arrays``
    (in leaf order) as tensors on ``device``; shapes are checked."""
    leaves = tree_lib.leaves(like)
    if len(leaves) != len(arrays):
        raise ValueError(f"template has {len(leaves)} leaves, got "
                         f"{len(arrays)} arrays")
    out = []
    for key, leaf, a in zip(tree_lib.tree_keys(like), leaves, arrays):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: {a.shape} != {tuple(leaf.shape)}")
        out.append(to_tensor(a, device).to(leaf.dtype))
    return tree_lib.unflatten(like, out)


def to_leaves(tree: PyTree) -> list[np.ndarray]:
    """Host numpy copies of a port tree's leaves, in leaf order."""
    return [to_numpy(x) for x in tree_lib.leaves(tree)]


def write_params0(path: str, keys: Sequence[str],
                  arrays: Sequence[Any]) -> str:
    """Write initial leaves by path key to an npz a workload config can
    name under ``"params0"`` (``runtime.workload``)."""
    np.savez(path, **{k: np.asarray(a) for k, a in zip(keys, arrays)})
    return path

"""Carry the JAX package's state across to the port, and back.

Both packages flatten a tree in the same leaf order and name every leaf by
the same ``/``-joined path (``repro_torch.tree``), so state crosses as a
plain list of numpy leaves: ``jax.tree_util.tree_leaves(x)`` converted
with ``numpy.asarray`` on one side, ``from_leaves`` onto a port template
on the other. Params, optimizer state and ISP residual all cross this way,
and so does the simulator's stacked state (``load_simulator_state``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.core import consistency as cons
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


def load_simulator_state(sim, replicas: Sequence[Any],
                         opt_state: Sequence[Any],
                         isp_state: Optional[Sequence[Any]] = None,
                         ssp_state: Optional[Sequence[Any]] = None) -> None:
    """Carry the JAX simulator's training state into the port's ``sim``
    (a ``core.simulator.ServerlessSimulator`` of the same config), so both
    go on with the same run. Each argument is the leaves of the JAX
    simulator's attribute of that name, in leaf order: the stacked
    replicas; the vmapped ``OptState`` (``step`` of shape (P,), then the
    moments); ``ISPWorkerState`` (residuals, then ``step``) under ISP;
    ``SSPState`` (queue, then ``step``) under SSP. The steps of the two
    consistency states become host ints, as the port keeps them."""
    dev = sim.device
    sim.replicas = from_leaves(sim.replicas, replicas, dev)
    sim.opt_state = from_leaves(sim.opt_state, opt_state, dev)
    if sim.isp_state is not None:
        *res, step = isp_state
        sim.isp_state = cons.ISPWorkerState(
            from_leaves(sim.isp_state.residual, res, dev), int(step))
    if sim.ssp_state is not None:
        *queue, step = ssp_state
        sim.ssp_state = cons.SSPState(
            from_leaves(sim.ssp_state.queue, queue, dev), int(step))

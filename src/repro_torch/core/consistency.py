"""Consistency models: BSP, SSP, ISP (port of ``repro.core.consistency``).

These define *when a worker may proceed* and *which updates it sees*:

* **BSP**: every worker sees the sum of all updates, every step.
* **SSP** with slack ``s``: a worker at step t has seen every update from
  steps <= t - s - 1; remote updates are delivered with the largest delay
  the bound allows (a delay queue).
* **ISP**: a barrier each step, but each worker broadcasts only the
  significant part of its accumulated update (``core.isp``); on CUDA
  tensors the split is the B1 kernel.

Every function works on trees whose leaves carry a leading worker axis
(P, ...), the simulator's stacked replicas. Sums over that axis (and over
SSP's queue) are left folds, ``x[0] + x[1] + ...``: the order in which XLA
reduces a leading axis, so the port's sums are the JAX package's bit for
bit, on the CPU and on the card alike.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.core import isp as isp_lib
from repro_torch.kernels.significance import significance_filter

PyTree = Any


class Model(enum.Enum):
    BSP = "bsp"
    SSP = "ssp"
    ISP = "isp"


@dataclasses.dataclass(frozen=True)
class ConsistencyConfig:
    model: Model = Model.BSP
    isp: isp_lib.ISPConfig = dataclasses.field(
        default_factory=isp_lib.ISPConfig)
    slack: int = 3  # SSP (paper §6.4 uses s = 3)


def fold(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0, added in order (see the module docstring)."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def _zeros(params_stacked: PyTree, lead: tuple, device) -> PyTree:
    dev = device_lib.resolve(device)
    return tree_lib.tree_map(
        lambda p: torch.zeros(lead + tuple(p.shape), dtype=p.dtype,
                              device=dev), params_stacked)


class SSPState(NamedTuple):
    """SSP's delay queue: ``queue[d]`` (each leaf (slack, P, ...)) holds the
    updates produced d + 1 steps ago; the oldest slot drains every step."""

    queue: PyTree
    step: int


def ssp_init(params_stacked: PyTree, slack: int,
             device: Optional[Any] = None) -> SSPState:
    """A zero queue of ``slack`` slots on ``device`` (default ``cuda``)."""
    return SSPState(_zeros(params_stacked, (slack,), device), 1)


def ssp_step(state: SSPState, updates: PyTree) -> tuple[PyTree, SSPState]:
    """One SSP exchange: each worker applies its own update at once and
    everyone's update of ``slack`` steps ago. Returns the updates visible
    to each worker (leading axis P) and the new state."""
    visible, queue = [], []
    for q, u in zip(tree_lib.leaves(state.queue), tree_lib.leaves(updates)):
        delivered = q[-1]
        # every worker's own old update is in the sum and already applied
        visible.append(u + fold(delivered)[None] - delivered)
        queue.append(torch.cat([u[None], q[:-1]]))
    return (tree_lib.unflatten(updates, visible),
            SSPState(tree_lib.unflatten(updates, queue), state.step + 1))


def ssp_drain(state: SSPState) -> PyTree:
    """What every worker has not yet seen of the updates still in flight
    (applied at job end)."""

    def leaf(q):
        per_worker = fold(q)  # (P, ...)
        return fold(per_worker)[None] - per_worker

    return tree_lib.tree_map(leaf, state.queue)


def bsp_exchange(updates: PyTree) -> PyTree:
    """Every worker's slice of the result is the sum over workers."""
    return tree_lib.tree_map(lambda u: fold(u)[None].expand(u.shape),
                             updates)


class ISPWorkerState(NamedTuple):
    """Per-worker residuals (leaves (P, ...)) and the 1-indexed step."""

    residual: PyTree
    step: int


def isp_init(params_stacked: PyTree,
             device: Optional[Any] = None) -> ISPWorkerState:
    """Zero residuals on ``device`` (default ``cuda``), at step 1."""
    return ISPWorkerState(_zeros(params_stacked, (), device), 1)


def isp_split(config: isp_lib.ISPConfig, state: ISPWorkerState,
              updates: PyTree, replicas: PyTree):
    """``isp_exchange`` returning the significant parts ``sig`` in place of
    their masks (``sig != 0`` is the mask, exactly: a significant entry has
    ``|acc| > v_t·max(|x|, floor) >= 0``), which B6 can count.

    Per worker p, ``acc_p = r_p + u_p`` is split against p's own replica
    (B1 fuses the accumulate; each worker tests against its own ``x``, so
    B1 sees no shared parameters). Worker p then sees its own update and
    the others' significant parts, ``u_p + sum_p' sig_p' - sig_p``, and
    keeps the insignificant remainder as its residual."""
    v_t = config.threshold(state.step)
    visible, res, sig = [], [], []
    for u, x, r in zip(tree_lib.leaves(updates), tree_lib.leaves(replicas),
                       tree_lib.leaves(state.residual)):
        s, rr = significance_filter(u, x, r, v_t, config.absolute_floor)
        visible.append(u + fold(s)[None] - s)
        res.append(rr)
        sig.append(s)
    return (tree_lib.unflatten(updates, visible),
            ISPWorkerState(tree_lib.unflatten(updates, res), state.step + 1),
            tree_lib.unflatten(updates, sig))


def isp_exchange(config: isp_lib.ISPConfig, state: ISPWorkerState,
                 updates: PyTree, replicas: PyTree):
    """One ISP exchange under the paper's replica semantics: ``(visible,
    new_state, masks)`` with leading (P, ...) axes (see ``isp_split``)."""
    visible, state, sig = isp_split(config, state, updates, replicas)
    return visible, state, tree_lib.tree_map(lambda s: s != 0, sig)

"""Elastic pool transitions (``repro.dist.elastic``).

The scale-in auto-tuner decides *when* the pool shrinks; this module says
what a shrink does to the pod path's state:

1. **Weak scaling** (paper §3.2): the global batch is ``B_g = P * B``.
2. **Mesh schedule**: a pool of P pods trains on mesh ``(P, data,
   model)``, and P == 1 drops the pod axis (``mesh_shape_for``). The port
   keeps the pod axis as a leading tensor dimension on one card, so the
   shapes only decide when the transition restores from its checkpoint.
3. **Reintegration**: mean-preserving averaging of a leaving replica
   (``reintegrate_into``, ``reintegrate_replicas``), or, on the pod path,
   the evicted pods' residuals flushed into the shared parameters
   (``apply_transition``), so no update mass is lost.
4. **Checkpoint-mediated restore** (``resharded_restore``): onto the
   state's device. ``make_mesh_for`` and the sharded restore of the JAX
   package wait for a port with more than one card (ROADMAP.md).

Divisions and sums run in the JAX package's types: a divisor is a 0-d
tensor on the leaf's device (PyTorch on CUDA divides by a Python scalar or
a CPU scalar through its reciprocal, which rounds differently), and pod
sums are ``compression.pod_sum``, float32 in pod order as XLA reduces
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.dist.compression import pod_sum

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Static description of an elastic training pool.

    Attributes:
      initial_pods: P at job start (the auto-tuner only ever shrinks).
      per_pod_batch: B, each pod's fixed local batch (weak scaling).
      data: within-pod data-parallel axis size.
      model: within-pod tensor/expert-parallel axis size.
      min_pods: the auto-tuner's floor (paper: never below 1).
    """

    initial_pods: int
    per_pod_batch: int
    data: int = 1
    model: int = 1
    min_pods: int = 1

    def __post_init__(self):
        if self.initial_pods < 1 or self.per_pod_batch < 1:
            raise ValueError("initial_pods and per_pod_batch must be >= 1")
        if not 1 <= self.min_pods <= self.initial_pods:
            raise ValueError(
                f"min_pods must be in [1, {self.initial_pods}], "
                f"got {self.min_pods}")

    def global_batch(self, pods: int) -> int:
        """B_g = P * B — the weak-scaling contract (paper §3.2)."""
        self.validate_pool(pods)
        return pods * self.per_pod_batch

    def mesh_shape(self, pods: int) -> tuple[int, ...]:
        self.validate_pool(pods)
        return mesh_shape_for(pods, data=self.data, model=self.model)

    def mesh_axes(self, pods: int) -> tuple[str, ...]:
        self.validate_pool(pods)
        return mesh_axes_for(pods)

    def validate_pool(self, pods: int) -> None:
        if not self.min_pods <= pods <= self.initial_pods:
            raise ValueError(
                f"pool size {pods} outside "
                f"[{self.min_pods}, {self.initial_pods}]")


def mesh_shape_for(pods: int, data: int = 16,
                   model: int = 16) -> tuple[int, ...]:
    """Device-mesh shape for a pool of ``pods``; P == 1 drops the pod axis."""
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    if pods == 1:
        return (data, model)
    return (pods, data, model)


def mesh_axes_for(pods: int) -> tuple[str, ...]:
    """Axis names matching ``mesh_shape_for``."""
    if pods == 1:
        return ("data", "model")
    return ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class PoolTransition:
    """One scale-in step: everything the runtime needs to re-mesh."""

    old_pods: int
    new_pods: int
    evicted: tuple[int, ...]  # pod indices leaving (highest indices first)
    old_global_batch: int
    new_global_batch: int
    old_mesh_shape: tuple[int, ...]
    new_mesh_shape: tuple[int, ...]


def plan_transition(plan: ElasticPlan, old_pods: int,
                    new_pods: int) -> PoolTransition:
    """Describe the old_pods -> new_pods shrink (evicts the top slots)."""
    plan.validate_pool(old_pods)
    plan.validate_pool(new_pods)
    if new_pods >= old_pods:
        raise ValueError(
            f"elastic transitions only shrink: {old_pods} -> {new_pods}")
    return PoolTransition(
        old_pods=old_pods,
        new_pods=new_pods,
        evicted=tuple(range(new_pods, old_pods)),
        old_global_batch=plan.global_batch(old_pods),
        new_global_batch=plan.global_batch(new_pods),
        old_mesh_shape=plan.mesh_shape(old_pods),
        new_mesh_shape=plan.mesh_shape(new_pods),
    )


def transition_schedule(plan: ElasticPlan,
                        pool_sizes: Sequence[int]) -> list[PoolTransition]:
    """The monotone shrink schedule through ``pool_sizes``, which must
    start at ``plan.initial_pods`` and decrease."""
    sizes = list(pool_sizes)
    if not sizes or sizes[0] != plan.initial_pods:
        raise ValueError(
            f"schedule must start at initial_pods={plan.initial_pods}")
    return [plan_transition(plan, a, b) for a, b in zip(sizes[:-1], sizes[1:])]


# -- state surgery ------------------------------------------------------------


def shrink_pod_state(tree_pod: PyTree, new_pods: int) -> PyTree:
    """The first ``new_pods`` slices of every (P, ...) leaf (views: the
    evicted slices' memory goes when the next step replaces the state)."""
    return tree_lib.tree_map(lambda x: x[:new_pods], tree_pod)


def _divisor(pool_before, like: torch.Tensor) -> torch.Tensor:
    """``pool_before`` as a 0-d tensor on ``like``'s device: a tensor keeps
    its dtype; a Python number takes ``like``'s dtype, as JAX's weak
    typing gives it."""
    if isinstance(pool_before, torch.Tensor):
        return pool_before.to(like.device)
    return torch.full((), float(pool_before), dtype=like.dtype,
                      device=like.device)


def reintegrate_into(own: PyTree, leaving: PyTree, pool_before) -> PyTree:
    """One survivor's mean-preserving pull of a leaving replica,
    ``x' = x + (x_leaving - x) / P_old``, leafwise.

    Applied by every survivor, the pool-mean parameter vector is
    unchanged. ``pool_before`` is a Python number or a 0-d tensor (the FaaS
    worker passes float32, as the JAX worker does); either way the
    division is by a tensor on the leaf's device.
    """
    return tree_lib.tree_map(
        lambda x, l: x + (l - x) / _divisor(pool_before, x), own, leaving)


def reintegrate_replicas(replicas: PyTree, evicted: int,
                         active_mask: torch.Tensor) -> PyTree:
    """Mean-preserving model averaging on eviction (replica semantics):
    ``x_p' = x_p + (x_evicted - x_p) / P_old`` for the active ``p``.

    ``replicas`` leaves have a leading worker axis (P, ...); ``active_mask``
    is a bool (P,) with the evicted worker already cleared.
    """
    p_old = active_mask.shape[0]

    def leaf(x):
        leaving = x[evicted][None].expand_as(x)
        mask = active_mask.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, reintegrate_into(x, leaving, p_old), x)

    return tree_lib.tree_map(leaf, replicas)


def apply_transition(
    tr: PoolTransition, params: PyTree, opt_state_pod: PyTree,
    residual_pod: PyTree,
) -> tuple[PyTree, PyTree, PyTree]:
    """Error-feedback reintegration and state surgery for one shrink: the
    evicted pods' residuals (mass they accumulated but never sent) are
    summed in float32 and added to the shared parameters; the survivors'
    slices of the optimizer state and residual are kept as they are."""

    def flush(p, r):
        return (p.float() + pod_sum(r[tr.new_pods:])).to(p.dtype)

    params = tree_lib.tree_map(flush, params, residual_pod)
    return (params, shrink_pod_state(opt_state_pod, tr.new_pods),
            shrink_pod_state(residual_pod, tr.new_pods))


# -- checkpoint-mediated restore ---------------------------------------------


def resharded_restore(directory: str, step: int, like: PyTree, pods: int, *,
                      data: int = 1, model: int = 1) -> PyTree:
    """Restore a checkpoint for a (possibly different) pool: the JAX
    package places it under the new pool's mesh; the port keeps one device
    and restores every leaf onto the device of ``like``'s leaves."""
    mesh_shape_for(pods, data=data, model=model)  # validates the pool
    device = tree_lib.leaves(like)[0].device
    return ckpt_store.restore(directory, step, like, device)

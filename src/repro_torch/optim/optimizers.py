"""Optimizers returning additive updates u_t (port of ``repro.optim``).

Same ``OptState(step, mu, nu)`` layout as the JAX package, so checkpoints
key on ``opt/step`` and ``opt/mu/...`` in both. ``step`` is a 0-d int32
tensor on the parameters' device; the math is float32 tensor arithmetic in
the JAX package's order of operations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tree_lib

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 1-indexed
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], tuple[PyTree, OptState]]


def _zeros_like_tree(params: PyTree) -> PyTree:
    return tree_lib.tree_map(torch.zeros_like, params)


def _device_of(params: PyTree) -> torch.device:
    return tree_lib.leaves(params)[0].device


def _step0(params: PyTree) -> torch.Tensor:
    return torch.ones((), dtype=torch.int32, device=_device_of(params))


def _lr_at(lr: float, step: torch.Tensor, decay: bool) -> torch.Tensor:
    """eta_t = eta / sqrt(t) with decay, else eta (float32)."""
    base = torch.tensor(lr, dtype=torch.float32, device=step.device)
    if not decay:
        return base
    t = torch.clamp_min(step.to(torch.float32), 1.0)
    return base / torch.sqrt(t)


def sgd(lr: float, lr_decay: bool = False) -> Optimizer:
    """u_t = -eta_t * g_t."""

    def init(params):
        z = _zeros_like_tree(params)
        return OptState(_step0(params), z, z)

    def update(grads, state, params):
        eta = _lr_at(lr, state.step, lr_decay)
        updates = tree_lib.tree_map(lambda g: -eta * g, grads)
        return updates, OptState(state.step + 1, state.mu, state.nu)

    return Optimizer("sgd", init, update)


def nesterov(lr: float, momentum: float = 0.9,
             lr_decay: bool = False) -> Optimizer:
    """m_t = beta*m_{t-1} + g_t ;  u_t = -eta * (g_t + beta*m_t)."""

    def init(params):
        z = _zeros_like_tree(params)
        return OptState(_step0(params), z, z)

    def update(grads, state, params):
        eta = _lr_at(lr, state.step, lr_decay)
        mu = tree_lib.tree_map(lambda m, g: momentum * m + g, state.mu, grads)
        updates = tree_lib.tree_map(
            lambda g, m: -eta * (g + momentum * m), grads, mu)
        return updates, OptState(state.step + 1, mu, state.nu)

    return Optimizer("nesterov", init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         lr_decay: bool = False, weight_decay: float = 0.0) -> Optimizer:
    """Adam with optional decoupled weight decay."""

    def init(params):
        return OptState(_step0(params), _zeros_like_tree(params),
                        _zeros_like_tree(params))

    def update(grads, state, params):
        t = state.step.to(torch.float32)
        eta = _lr_at(lr, state.step, lr_decay)
        mu = tree_lib.tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                               state.mu, grads)
        nu = tree_lib.tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g),
                               state.nu, grads)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        bc1 = one - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = one - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=t.device), t)

        def leaf(m, v, p):
            u = -eta * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - eta * weight_decay * p
            return u

        updates = tree_lib.tree_map(leaf, mu, nu, params)
        return updates, OptState(state.step + 1, mu, nu)

    return Optimizer("adam", init, update)


_REGISTRY: dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "nesterov": nesterov,
    "adam": adam,
}


def make(name: str, lr: float, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](lr, **kwargs)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """x_t = x_{t-1} + u_t."""
    return tree_lib.tree_map(lambda p, u: p + u, params, updates)

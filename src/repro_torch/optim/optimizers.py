"""Optimizers returning additive updates u_t (port of ``repro.optim``).

Same ``OptState(step, mu, nu)`` layout as the JAX package, so checkpoints
key on ``opt/step`` and ``opt/mu/...`` in both. ``step`` is a 0-d int32
tensor on the parameters' device. The math follows the JAX package's order
of operations and its type promotion, so a bfloat16 leaf rounds where the
JAX update rounds it:

* a Python constant in JAX is weakly typed and takes the leaf's dtype
  (``b1 * m`` multiplies by ``bf16(0.9)``), so here it is a 0-d tensor of
  the leaf's dtype (PyTorch would keep a Python float at float32);
* a float32 0-d array in JAX (``eta``, ``bc1``) promotes a bfloat16 leaf to
  float32, so here the leaf is cast up first (PyTorch would round the
  0-d tensor to the leaf's dtype instead);
* the update is cast back to the leaf's dtype at the end.

Device constants are made with ``torch.full`` (a fill on the card, no copy
from the host, so no wait for the card). On float32 leaves every one of
these is a no-op.
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
    # the settings a fused kernel needs to take ``update``'s place
    hparams: dict = dataclasses.field(default_factory=dict)


def _zeros_like_tree(params: PyTree) -> PyTree:
    return tree_lib.tree_map(torch.zeros_like, params)


def _device_of(params: PyTree) -> torch.device:
    return tree_lib.leaves(params)[0].device


def _step0(params: PyTree) -> torch.Tensor:
    return torch.ones((), dtype=torch.int32, device=_device_of(params))


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX's weak typing applies it to ``like``: a 0-d
    tensor of ``like``'s dtype (on the CPU, where PyTorch takes it as a
    scalar for any device; multiplication only, never a divisor)."""
    return torch.tensor(value, dtype=like.dtype)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA computes it.
    PyTorch's float32 sqrt on the CPU is not: about 0.6% of its results
    are one place off. On the CPU this takes the root in float64 and
    rounds it, which is the correctly rounded float32 root; on the card
    ``torch.sqrt`` already is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _lr_at(lr: float, step: torch.Tensor, decay: bool) -> torch.Tensor:
    """eta_t = eta / sqrt(t) with decay, else eta (float32)."""
    base = _f32(lr, step.device)
    if not decay:
        return base
    t = torch.clamp_min(step.to(torch.float32), 1.0)
    return base / _sqrt(t)


def sgd(lr: float, lr_decay: bool = False) -> Optimizer:
    """u_t = -eta_t * g_t."""

    def init(params):
        z = _zeros_like_tree(params)
        return OptState(_step0(params), z, z)

    def update(grads, state, params):
        eta = _lr_at(lr, state.step, lr_decay)
        updates = tree_lib.tree_map(
            lambda g: (-eta * g.float()).to(g.dtype), grads)
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
        mu = tree_lib.tree_map(lambda m, g: _weak(momentum, m) * m + g,
                               state.mu, grads)
        updates = tree_lib.tree_map(
            lambda g, m: (-eta * (g + _weak(momentum, m) * m).float()).to(
                g.dtype), grads, mu)
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
        mu = tree_lib.tree_map(
            lambda m, g: _weak(b1, m) * m + _weak(1 - b1, g) * g,
            state.mu, grads)
        nu = tree_lib.tree_map(
            lambda v, g: _weak(b2, v) * v + _weak(1 - b2, g) * (g * g),
            state.nu, grads)
        one = _f32(1.0, t.device)
        bc1 = one - torch.pow(_f32(b1, t.device), t)
        bc2 = one - torch.pow(_f32(b2, t.device), t)

        def leaf(m, v, p):
            # float32 from here on, as JAX promotes m / bc1
            u = -eta * (m.float() / bc1) / (_sqrt(v.float() / bc2) + eps)
            if weight_decay:
                u = u - eta * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_lib.tree_map(leaf, mu, nu, params)
        return updates, OptState(state.step + 1, mu, nu)

    return Optimizer("adam", init, update, dict(
        lr=lr, b1=b1, b2=b2, eps=eps, lr_decay=lr_decay,
        weight_decay=weight_decay))


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
    return tree_lib.tree_map(lambda p, u: (p + u).to(p.dtype), params,
                             updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; the leaves'
    sums are added in leaf order (a left fold, as ``jax.tree.reduce``).
    The root is taken in float64 and rounded, which is the correctly
    rounded float32 root (PyTorch's float32 sqrt on the CPU is not)."""
    total = None
    for g in tree_lib.leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total.double()).float()


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``.

    The scale is a float32 tensor / tensor division (PyTorch divides a
    Python scalar by a tensor through a reciprocal, which rounds
    differently), and each leaf is scaled in float32 and cast back, as
    JAX promotes ``g * scale``."""
    norm = global_norm(grads)
    dev = norm.device
    scale = torch.minimum(_f32(1.0, dev), _f32(max_norm, dev) / torch.maximum(
        norm, _f32(1e-12, dev)))
    return tree_lib.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)

"""Parameter definitions: shape, type and init, declared once per layer.

The port's counterpart of ``repro.models.params``. Every layer declares its
parameters as a tree of ``ParamDef``; ``materialize`` makes real tensors,
``empty`` allocation-free templates (``meta`` tensors), and ``count_params``
/ ``param_bytes`` read the declaration alone. The JAX ``ParamDef`` also
carries a mesh ``PartitionSpec``; the port runs on one card and has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from repro_torch import tree as tree_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter tensor: shape, dtype and init style."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones
    init_scale: float = 1.0


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map(fn, defs: PyTree) -> PyTree:
    return tree_lib.unflatten(defs, [fn(d) for d in tree_lib.leaves(defs)])


def stack(defs: PyTree, n: int) -> PyTree:
    """Prepend a layers axis of size ``n`` to every def."""
    return _map(lambda d: dataclasses.replace(d, shape=(n,) + d.shape), defs)


def empty(defs: PyTree, device: Union[str, torch.device] = "meta") -> PyTree:
    """Uninitialised tensors of every def (``meta``: no allocation) — a
    template for ``convert.from_leaves``."""
    return _map(lambda d: torch.empty(d.shape, dtype=d.dtype, device=device),
                defs)


def zeros(defs: PyTree, device: Union[str, torch.device]) -> PyTree:
    return _map(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device),
                defs)


def materialize(defs: PyTree, seed: int,
                device: Union[str, torch.device] = "cpu") -> PyTree:
    """Real tensors for every def, fan-in-scaled normal by default.

    One ``torch.Generator`` on ``device``, seeded with ``seed``, draws the
    leaves in leaf order, one leaf at a time in float32, each then cast to
    its dtype. The draws are not ``jax.random``'s: parity with the JAX
    package carries its parameters across (``convert.from_leaves``).
    """
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        # fan-in scaling over the last-but-one dim (or last for 1-D)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        scale = d.init_scale / float(max(fan_in, 1)) ** 0.5
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(d.dtype)

    return _map(one, defs)


def _numel(d: ParamDef) -> int:
    n = 1
    for s in d.shape:
        n *= s
    return n


def count_params(defs: PyTree) -> int:
    return sum(_numel(d) for d in tree_lib.leaves(defs))


def param_bytes(defs: PyTree) -> int:
    return sum(_numel(d) * d.dtype.itemsize for d in tree_lib.leaves(defs))

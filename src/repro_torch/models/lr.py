"""Logistic regression, dense and sparse (port of ``repro.models.lr``).

The paper trains LR on Criteo in two forms: *dense* (13 numerical features)
and *sparse* (26 categorical features hashed into a 1e5-dim space plus the
13 numericals). Sparse minibatches are fixed-width ``(idx, val)`` rows per
sample. The gradient comes from autograd: the dense logits are one float32
matrix-vector product, the sparse ones a gather whose backward is an
index-add (deterministic on the card under
``torch.use_deterministic_algorithms``, which the worker sets).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LRConfig:
    n_features: int  # 13 for dense-Criteo, 100_013 for sparse-Criteo
    l2: float = 0.0
    sparse: bool = False
    nnz_per_sample: int = 39  # 13 numerical + 26 hashed categoricals


class LRParams(NamedTuple):
    w: torch.Tensor  # (n_features,)
    b: torch.Tensor  # ()


class DenseBatch(NamedTuple):
    x: torch.Tensor  # (B, n_features) float32
    y: torch.Tensor  # (B,) float32 in {0,1}


class SparseBatch(NamedTuple):
    """Fixed-width sparse rows: idx/val padded to nnz_per_sample with
    idx=0, val=0."""

    idx: torch.Tensor  # (B, nnz) int64
    val: torch.Tensor  # (B, nnz) float32
    y: torch.Tensor  # (B,) float32


def init(config: LRConfig, generator: torch.Generator,
         device: Optional[torch.device] = None) -> LRParams:
    """Seeded normal init with scale 0.01 and a zero bias. Not the JAX
    package's draw (``jax.random`` bits cannot be reproduced in torch):
    parity runs pass the JAX init in as arrays instead."""
    w = 0.01 * torch.randn(config.n_features, generator=generator)
    return LRParams(w=w.to(device), b=torch.zeros((), device=device))


def _logits_dense(params: LRParams, x: torch.Tensor) -> torch.Tensor:
    return x @ params.w + params.b


def _logits_sparse(params: LRParams, idx: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    # gather weights at the nonzero coordinates: (B, nnz)
    return torch.sum(params.w[idx] * val, dim=-1) + params.b


def _logits(config: LRConfig, params: LRParams, batch) -> torch.Tensor:
    if config.sparse:
        return _logits_sparse(params, batch.idx, batch.val)
    return _logits_dense(params, batch.x)


def bce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy (the paper's LR convergence metric)."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.mean(torch.maximum(logits, zero) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(config: LRConfig, params: LRParams, batch) -> torch.Tensor:
    loss = bce_loss(_logits(config, params, batch), batch.y)
    if config.l2:
        loss = loss + 0.5 * config.l2 * torch.sum(params.w * params.w)
    return loss


def grad_fn(config: LRConfig, params: LRParams, batch):
    """``(loss, grads)`` with grads an ``LRParams``. Sparse grads are
    naturally sparse: only coordinates the minibatch touches are nonzero
    (the paper's 'intrinsic filter')."""
    w = params.w.detach().requires_grad_(True)
    b = params.b.detach().requires_grad_(True)
    loss = loss_fn(config, LRParams(w, b), batch)
    gw, gb = torch.autograd.grad(loss, (w, b))
    return loss.detach(), LRParams(gw, gb)


def accuracy(config: LRConfig, params: LRParams, batch) -> torch.Tensor:
    logits = _logits(config, params, batch)
    return torch.mean(((logits > 0).to(torch.float32) == batch.y).to(
        torch.float32))

"""Probabilistic matrix factorization (port of ``repro.models.pmf``).

R (N_u x N_m, partially observed) ~ U @ M with U: (N_u, r), M: (r, N_m);
minibatches are (user, movie, rating) triples. The gradient comes from
autograd: each triple touches one row of U and one column of M, so the
gradients are dense tensors that are zero almost everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PMFConfig:
    n_users: int
    n_movies: int
    rank: int = 20
    lambda_u: float = 0.02
    lambda_m: float = 0.02


class PMFParams(NamedTuple):
    U: torch.Tensor  # (n_users, rank)
    M: torch.Tensor  # (rank, n_movies)


class RatingsBatch(NamedTuple):
    user: torch.Tensor  # (B,) int64
    movie: torch.Tensor  # (B,) int64
    rating: torch.Tensor  # (B,) float32


def init(config: PMFConfig, generator: torch.Generator,
         device: Optional[torch.device] = None) -> PMFParams:
    """Seeded normal init with scale 1/sqrt(rank). Not the JAX package's
    draw (``jax.random`` bits cannot be reproduced in torch): parity runs
    pass the JAX init in as arrays instead."""
    scale = 1.0 / float(config.rank) ** 0.5
    U = scale * torch.randn(config.n_users, config.rank, generator=generator)
    M = scale * torch.randn(config.rank, config.n_movies, generator=generator)
    return PMFParams(U.to(device), M.to(device))


def predict(params: PMFParams, user: torch.Tensor, movie: torch.Tensor):
    u = params.U[user]  # (B, r)
    m = params.M[:, movie].T  # (B, r)
    return torch.sum(u * m, dim=-1)


def loss_fn(config: PMFConfig, params: PMFParams, batch: RatingsBatch):
    """Regularised MSE over the minibatch."""
    err = predict(params, batch.user, batch.movie) - batch.rating
    mse = torch.mean(err * err)
    uu = params.U[batch.user]
    mm = params.M[:, batch.movie]
    reg = config.lambda_u * torch.mean(torch.sum(uu * uu, -1))
    reg = reg + config.lambda_m * torch.mean(torch.sum(mm * mm, 0))
    return mse + reg


def rmse(params: PMFParams, batch: RatingsBatch) -> torch.Tensor:
    err = predict(params, batch.user, batch.movie) - batch.rating
    return torch.sqrt(torch.mean(err * err))


def grad_fn(config: PMFConfig, params: PMFParams, batch: RatingsBatch):
    """``(loss, grads)`` with grads a ``PMFParams`` of dense tensors."""
    U = params.U.detach().requires_grad_(True)
    M = params.M.detach().requires_grad_(True)
    loss = loss_fn(config, PMFParams(U, M), batch)
    gU, gM = torch.autograd.grad(loss, (U, M))
    return loss.detach(), PMFParams(gU, gM)

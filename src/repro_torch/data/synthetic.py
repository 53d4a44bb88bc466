"""Synthetic, statistically-matched stand-ins for the paper's datasets
(copy of ``repro.data.synthetic``'s generators).

The generators are pure numpy, so the same seed gives the same arrays,
bit for bit, in both packages. The batch helpers at the end put a
selection of those arrays on an explicit device as the port's model
batches (int64 indices, the workloads' convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models.lr import DenseBatch, SparseBatch
from repro_torch.models.pmf import RatingsBatch


@dataclasses.dataclass(frozen=True)
class CriteoLikeConfig:
    """Criteo display-ads lookalike (paper: 47M samples, 13 num + 26 cat).

    A planted-model classification task: a ground-truth weight vector draws
    labels through a logistic link, so BCE genuinely decreases under
    training and convergence thresholds are meaningful.
    """

    n_samples: int = 200_000
    n_numerical: int = 13
    n_categorical: int = 26
    hash_dim: int = 100_000  # paper's 1e5 hashing trick
    label_noise: float = 0.08
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MovieLensLikeConfig:
    """MovieLens lookalike: Zipf-popular users/movies, low-rank ground truth."""

    n_users: int = 10_681  # ML-10M dimensions by default
    n_movies: int = 71_567
    n_ratings: int = 400_000
    rank: int = 20
    rating_noise: float = 0.25
    seed: int = 0


def make_criteo_dense(cfg: CriteoLikeConfig) -> tuple[np.ndarray, np.ndarray]:
    """Returns (x, y): x (N, 13) min-max-normalised, y (N,) in {0,1}."""
    rng = np.random.default_rng(cfg.seed)
    x = rng.lognormal(0.0, 1.0, size=(cfg.n_samples, cfg.n_numerical)).astype(
        np.float32
    )
    # min-max scaling — the paper's PyWren-IBM preprocessing step
    x = (x - x.min(0)) / np.maximum(x.max(0) - x.min(0), 1e-9)
    w_true = rng.normal(0.0, 2.0, size=cfg.n_numerical).astype(np.float32)
    logits = x @ w_true - (x @ w_true).mean()
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.uniform(size=cfg.n_samples) < p).astype(np.float32)
    flip = rng.uniform(size=cfg.n_samples) < cfg.label_noise
    y = np.where(flip, 1.0 - y, y).astype(np.float32)
    return x, y


def make_criteo_sparse(
    cfg: CriteoLikeConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (idx, val, y): fixed-width hashed-sparse rows.

    Each sample has 13 numerical coordinates (indices 0..12) plus 26
    categorical hashes (Zipf-distributed over the remaining hash space),
    mirroring the paper's 'hashing trick' construction.
    """
    rng = np.random.default_rng(cfg.seed + 1)
    n, nnz = cfg.n_samples, cfg.n_numerical + cfg.n_categorical
    num_idx = np.tile(np.arange(cfg.n_numerical, dtype=np.int32), (n, 1))
    num_val = rng.lognormal(0.0, 1.0, size=(n, cfg.n_numerical)).astype(np.float32)
    num_val = (num_val - num_val.min(0)) / np.maximum(
        num_val.max(0) - num_val.min(0), 1e-9
    )
    # Zipf-ish categorical hashes (heads are hot, like real ad categoricals)
    zipf = rng.zipf(1.3, size=(n, cfg.n_categorical)).astype(np.int64)
    cat_idx = (
        cfg.n_numerical + (zipf * 2654435761 % (cfg.hash_dim - cfg.n_numerical))
    ).astype(np.int32)
    cat_val = np.ones((n, cfg.n_categorical), np.float32)
    idx = np.concatenate([num_idx, cat_idx], axis=1)
    val = np.concatenate([num_val, cat_val], axis=1)
    # planted model over the hashed space
    w_true = rng.normal(0.0, 1.0, size=cfg.hash_dim).astype(np.float32)
    logits = (w_true[idx] * val).sum(1)
    logits -= logits.mean()
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    flip = rng.uniform(size=n) < cfg.label_noise
    y = np.where(flip, 1.0 - y, y).astype(np.float32)
    assert idx.shape == (n, nnz)
    return idx, val, y


def make_movielens(
    cfg: MovieLensLikeConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (user, movie, rating) triples with a planted low-rank model."""
    rng = np.random.default_rng(cfg.seed + 2)
    # Zipf popularity for users and movies (heavy-tailed, like MovieLens)
    u = rng.zipf(1.2, size=cfg.n_ratings) % cfg.n_users
    m = rng.zipf(1.1, size=cfg.n_ratings) % cfg.n_movies
    U = rng.normal(0, 1.0 / np.sqrt(cfg.rank), size=(cfg.n_users, cfg.rank))
    M = rng.normal(0, 1.0 / np.sqrt(cfg.rank), size=(cfg.n_movies, cfg.rank))
    base = (U[u] * M[m]).sum(1)
    # map to the 0.5..5.0 star scale
    r = 2.75 + 1.5 * np.tanh(base) + rng.normal(0, cfg.rating_noise, cfg.n_ratings)
    r = np.clip(np.round(r * 2) / 2, 0.5, 5.0).astype(np.float32)
    return u.astype(np.int32), m.astype(np.int32), r



# -- minibatches on a device (``repro.data.synthetic``'s batch helpers) -------


def _on(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device_lib.resolve(device), dtype=dtype)


def dense_batch(x: np.ndarray, y: np.ndarray, sl, device) -> DenseBatch:
    """The rows ``sl`` selects (a slice or an index array of any shape)."""
    return DenseBatch(x=_on(x[sl], device), y=_on(y[sl], device))


def sparse_batch(idx: np.ndarray, val: np.ndarray, y: np.ndarray, sl,
                 device) -> SparseBatch:
    return SparseBatch(idx=_on(idx[sl], device, torch.int64),
                       val=_on(val[sl], device), y=_on(y[sl], device))


def ratings_batch(u: np.ndarray, m: np.ndarray, r: np.ndarray, sl,
                  device) -> RatingsBatch:
    return RatingsBatch(user=_on(u[sl], device, torch.int64),
                        movie=_on(m[sl], device, torch.int64),
                        rating=_on(r[sl], device))

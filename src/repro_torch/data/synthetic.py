"""Synthetic MovieLens stand-in (copy of ``repro.data.synthetic``'s PMF part).

Pure numpy, so the same seed gives the same ratings in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MovieLensLikeConfig:
    """MovieLens lookalike: Zipf-popular users/movies, low-rank ground truth."""

    n_users: int = 10_681  # ML-10M dimensions by default
    n_movies: int = 71_567
    n_ratings: int = 400_000
    rank: int = 20
    rating_noise: float = 0.25
    seed: int = 0


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

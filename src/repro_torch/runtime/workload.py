"""Named, deterministic workloads for the FaaS runtime (port of
``repro.runtime.workload``).

A stateless worker gets a workload name plus a JSON config and must rebuild
data, initial parameters and minibatch store identically to every peer and
to the supervisor: ``build(name, cfg, device)`` is a pure function of its
arguments.

Both of the paper's jobs are here: ``pmf`` (MovieLens-like) and ``lr``
(dense Criteo-like, 13 features; the runtime's LR job is dense only, as in
the JAX package). The JAX package draws ``params0`` with ``jax.random``,
which torch cannot reproduce, so a config may name an npz file under
``"params0"`` holding the initial leaves by path key (``U``, ``M`` for
PMF; ``w``, ``b`` for LR) — the parity tests hand the JAX init over that
way. Without it the port draws a seeded ``torch.Generator`` init, which is
NOT a parity init.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.data.store import MinibatchStore

PyTree = Any


@dataclasses.dataclass
class Workload:
    """Everything a worker or supervisor needs about one training job."""

    name: str
    cfg: dict
    device: torch.device
    params0: PyTree
    grad_fn: Callable[[PyTree, Any], tuple[Any, PyTree]]
    store: MinibatchStore
    make_batch: Callable[[list[np.ndarray]], Any]
    eval_fn: Callable[[PyTree], float]

    @property
    def n_batches(self) -> int:
        return self.store.n_batches

    def batch(self, key: int):
        return self.make_batch(self.store.fetch(key))


def _pmf(cfg: dict, device: torch.device) -> Workload:
    from repro_torch.models import pmf

    c = {
        "n_users": 300,
        "n_movies": 500,
        "n_ratings": 24_000,
        "rank": 8,
        "batch_size": 256,
        "seed": 0,
        "eval_size": 2048,
        **cfg,
    }
    ml = synthetic.MovieLensLikeConfig(
        n_users=c["n_users"],
        n_movies=c["n_movies"],
        n_ratings=c["n_ratings"],
        rank=c["rank"],
        seed=c["seed"],
    )
    users, movies, ratings = synthetic.make_movielens(ml)
    mcfg = pmf.PMFConfig(n_users=ml.n_users, n_movies=ml.n_movies,
                         rank=ml.rank)
    if c.get("params0"):
        with np.load(c["params0"]) as z:
            params0 = pmf.PMFParams(
                U=torch.from_numpy(np.array(z["U"], np.float32)).to(device),
                M=torch.from_numpy(np.array(z["M"], np.float32)).to(device),
            )
        want = ((ml.n_users, ml.rank), (ml.rank, ml.n_movies))
        if (tuple(params0.U.shape), tuple(params0.M.shape)) != want:
            raise ValueError(f"params0 shapes {params0.U.shape}, "
                             f"{params0.M.shape} != {want}")
    else:
        gen = torch.Generator().manual_seed(int(c["seed"]))
        params0 = pmf.init(mcfg, gen, device)
    store = MinibatchStore([users, movies, ratings], c["batch_size"])
    rng = np.random.default_rng(c["seed"] + 17)
    eidx = rng.choice(
        len(ratings), min(c["eval_size"], len(ratings)), replace=False
    )

    def make_batch(arrays: list[np.ndarray]):
        u, m, r = arrays
        return pmf.RatingsBatch(
            user=torch.from_numpy(u.astype(np.int64)).to(device),
            movie=torch.from_numpy(m.astype(np.int64)).to(device),
            rating=torch.from_numpy(np.ascontiguousarray(r)).to(device),
        )

    eval_batch = make_batch([users[eidx], movies[eidx], ratings[eidx]])

    return Workload(
        name="pmf",
        cfg=c,
        device=device,
        params0=params0,
        grad_fn=partial(pmf.grad_fn, mcfg),
        store=store,
        make_batch=make_batch,
        eval_fn=lambda p: float(pmf.rmse(p, eval_batch)),
    )


def _lr(cfg: dict, device: torch.device) -> Workload:
    from repro_torch.models import lr

    c = {
        "n_samples": 20_000,
        "batch_size": 256,
        "seed": 0,
        "eval_size": 2048,
        **cfg,
    }
    like = synthetic.CriteoLikeConfig(n_samples=c["n_samples"],
                                      seed=c["seed"])
    x, y = synthetic.make_criteo_dense(like)
    lcfg = lr.LRConfig(n_features=like.n_numerical, sparse=False)
    if c.get("params0"):
        with np.load(c["params0"]) as z:
            params0 = lr.LRParams(
                w=torch.from_numpy(np.array(z["w"], np.float32)).to(device),
                b=torch.from_numpy(np.array(z["b"], np.float32)).to(device),
            )
        got = (tuple(params0.w.shape), tuple(params0.b.shape))
        if got != ((lcfg.n_features,), ()):
            raise ValueError(f"params0 shapes {got} != "
                             f"{((lcfg.n_features,), ())}")
    else:
        gen = torch.Generator().manual_seed(int(c["seed"]))
        params0 = lr.init(lcfg, gen, device)
    store = MinibatchStore([x, y], c["batch_size"])
    rng = np.random.default_rng(c["seed"] + 17)
    eidx = rng.choice(len(y), min(c["eval_size"], len(y)), replace=False)

    def make_batch(arrays: list[np.ndarray]):
        xb, yb = arrays
        return lr.DenseBatch(
            x=torch.from_numpy(np.ascontiguousarray(xb)).to(device),
            y=torch.from_numpy(np.ascontiguousarray(yb)).to(device),
        )

    eval_batch = make_batch([x[eidx], y[eidx]])

    return Workload(
        name="lr",
        cfg=c,
        device=device,
        params0=params0,
        grad_fn=partial(lr.grad_fn, lcfg),
        store=store,
        make_batch=make_batch,
        eval_fn=lambda p: float(lr.loss_fn(lcfg, p, eval_batch)),
    )


_REGISTRY: dict[str, Callable[[dict, torch.device], Workload]] = {
    "pmf": _pmf,
    "lr": _lr,
}

WORKLOAD_NAMES = tuple(sorted(_REGISTRY))


def build(name: str, cfg: Optional[dict] = None,
          device: Optional[str] = None) -> Workload:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown workload {name!r}; registered: {WORKLOAD_NAMES}"
        )
    return _REGISTRY[name](dict(cfg or {}), device_lib.resolve(device))

"""Minibatch store — the object-storage access pattern of the paper.

MLLess pre-partitions the dataset into fixed-size minibatches in IBM COS and
each worker fetches ``batch[(worker_id * step) % n_batches]`` style slices per
iteration. We reproduce that layout: arrays are chunked once, then addressed
by integer batch id. Fetches are free on CPU but the *simulator* charges the
COS latency from ``core.billing.CommModel.cos_fetch_s`` per fetch, which is
what the paper's step-time decomposition needs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class MinibatchStore:
    """Deterministic, shardable minibatch addressing over numpy arrays."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int):
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading dimension")
        self.arrays = list(arrays)
        self.batch_size = int(batch_size)
        self.n_samples = n
        self.n_batches = max(n // self.batch_size, 1)

    def fetch(self, batch_id: int) -> list[np.ndarray]:
        b = int(batch_id) % self.n_batches
        sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
        return [a[sl] for a in self.arrays]

    def batch_for(self, worker: int, step: int, n_workers: int) -> int:
        """Round-robin partitioning: worker w at step t reads batch
        t * P + w — disjoint coverage per step, wrap-around epochs."""
        return (step * n_workers + worker) % self.n_batches

    def fetch_stacked(self, step: int, n_workers: int) -> list[np.ndarray]:
        """All P workers' minibatches for one step, stacked on axis 0:
        returns arrays shaped (P, B, ...) — the simulator's vmapped layout."""
        per_worker = [
            self.fetch(self.batch_for(w, step, n_workers)) for w in range(n_workers)
        ]
        return [np.stack([pw[i] for pw in per_worker]) for i in range(len(self.arrays))]

    def bytes_per_batch(self) -> int:
        return int(sum(a[: self.batch_size].nbytes for a in self.arrays))

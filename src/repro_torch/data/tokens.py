"""Token pipeline for the LM architectures (``repro.data.tokens``).

Synthetic-but-structured token streams (Zipf unigram + Markov bigram
mixing), in numpy only: ``next_batch(step)`` gives the same int32 arrays as
the JAX package's pipeline for the same arguments (its seed,
``hash((seed, step))``, hashes a tuple of ints, which is stable across
processes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Deterministic synthetic LM data with a learnable bigram structure."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order_mix: float = 0.7  # fraction of tokens drawn from bigram table

    def _tables(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # structure lives in a small head space
        unigram = 1.0 / np.arange(1, v + 1) ** 1.1
        unigram /= unigram.sum()
        succ = rng.integers(0, v, size=(v, 4))  # 4 plausible successors each
        return unigram, succ

    def next_batch(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, each (global_batch, seq_len) int32."""
        rng = np.random.default_rng(hash((self.seed, step)) % (2**31))
        unigram, succ = self._tables()
        v = unigram.size
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=unigram)
        use_bigram = rng.uniform(size=(b, s)) < self.markov_order_mix
        succ_pick = rng.integers(0, succ.shape[1], size=(b, s))
        iid = rng.choice(v, size=(b, s), p=unigram)
        for t in range(s):
            prev = toks[:, t]
            bi = succ[prev, succ_pick[:, t]]
            toks[:, t + 1] = np.where(use_bigram[:, t], bi, iid[:, t])
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def synthetic_token_batch(vocab_size: int, seq_len: int, global_batch: int,
                          seed: int = 0) -> dict[str, np.ndarray]:
    """The pipeline's first batch (``{"tokens", "labels"}``, int32)."""
    return TokenPipeline(vocab_size, seq_len, global_batch, seed).next_batch(0)

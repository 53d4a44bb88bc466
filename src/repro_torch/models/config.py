"""Architecture configuration: one dataclass drives the whole LM stack.

An own copy of ``repro.models.config`` (the port imports nothing of the JAX
package). A model is a stack of *groups*; each group repeats one
*superblock*, an ordered tuple of block specs (attention / mLSTM / sLSTM
...). The port's forward loops over the repeats in Python, where the JAX
package lowers each group as one ``lax.scan``; the parameter trees keep the
JAX layout (one leading ``reps`` dimension per group), so parameters and
caches cross between the packages leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Mixer(enum.Enum):
    """Sequence-mixing block kinds."""

    GLOBAL_ATTN = "global_attn"  # full (causal) attention
    LOCAL_ATTN = "local_attn"  # sliding-window attention
    CROSS_ATTN = "cross_attn"  # encoder-decoder cross attention
    RGLRU = "rglru"  # Griffin-style gated linear recurrence
    MLSTM = "mlstm"  # xLSTM matrix-memory block
    SLSTM = "slstm"  # xLSTM scalar-memory block (sequential)


class FF(enum.Enum):
    """Feed-forward kinds (NONE for xLSTM blocks with internal projections)."""

    SWIGLU = "swiglu"
    GEGLU = "geglu"
    GELU = "gelu"  # plain 2-layer MLP
    MOE = "moe"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual block: pre-norm mixer + pre-norm FF."""

    mixer: Mixer
    ff: FF
    window: Optional[int] = None  # sliding-window size (LOCAL_ATTN)
    rope_base: Optional[float] = 10_000.0  # None = no RoPE (whisper)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Auxiliary encoder (whisper audio / paligemma vision-stub)."""

    n_layers: int
    ctx_len: int  # 1500 audio frames / 256 image patches
    d_model: Optional[int] = None  # defaults to decoder d_model
    precomputed: bool = True  # frontend is a stub: embeddings arrive as input


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # (superblock, repeats) groups; sum(len(sb) * reps) == total layers
    groups: tuple[tuple[tuple[BlockSpec, ...], int], ...]
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None  # enc-dec / VLM prefix tower
    prefix_lm: bool = False  # paligemma: bidirectional prefix attention
    tie_embeddings: bool = True
    max_seq_len: int = 131_072
    sub_quadratic: bool = False  # long_500k eligibility
    # dtypes
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # slstm/mlstm internal expansion
    lstm_proj_factor: float = 2.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table's
        vocab dim is shardable over any mesh axis (16/32/...). Padded logit
        columns are masked out of the softmax (layers.chunked_softmax_xent);
        padded rows are dead weights. Standard MaxText-style practice."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_layers(self) -> int:
        return sum(len(sb) * reps for sb, reps in self.groups)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, (
            f"{self.name}: heads {self.n_heads} % kv {self.n_kv_heads} != 0"
        )
        for sb, reps in self.groups:
            assert reps >= 1 and len(sb) >= 1
            for b in sb:
                if b.ff is FF.MOE:
                    assert self.moe is not None, f"{self.name}: MOE ff without moe cfg"
                if b.mixer is Mixer.LOCAL_ATTN:
                    assert b.window, f"{self.name}: local attn without window"


def uniform_groups(spec: BlockSpec, n_layers: int) -> tuple:
    """Homogeneous stack: one group of n_layers single-block superblocks."""
    return (((spec,), n_layers),)


def pattern_groups(pattern: tuple[BlockSpec, ...], n_layers: int) -> tuple:
    """Repeat ``pattern`` as a superblock; remainder becomes a second group."""
    plen = len(pattern)
    reps, rem = divmod(n_layers, plen)
    groups = []
    if reps:
        groups.append((pattern, reps))
    if rem:
        groups.append((pattern[:rem], 1))
    return tuple(groups)

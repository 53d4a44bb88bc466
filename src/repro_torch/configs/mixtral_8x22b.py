"""mixtral-8x22b [moe]: 56L, d_model=6144, 48H (GQA kv=8), d_ff=16384,
vocab=32768. MoE 8 experts top-2, sliding-window attention (4096).
This is the paper-representative sparse-regime arch (DESIGN.md §4): expert
gradients are step-sparse exactly like MLLess's hashing-trick LR.
[arXiv:2401.04088; hf]"""

from repro_torch.models.config import (
    ArchConfig, BlockSpec, FF, Mixer, MoEConfig, uniform_groups,
)

_SB = BlockSpec(Mixer.LOCAL_ATTN, FF.MOE, window=4096)

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    groups=uniform_groups(_SB, 56),
    moe=MoEConfig(n_experts=8, top_k=2),
    max_seq_len=65_536,
    sub_quadratic=True,  # SWA
)

SMOKE = ArchConfig(
    name="mixtral-smoke",
    family="moe",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    groups=uniform_groups(
        BlockSpec(Mixer.LOCAL_ATTN, FF.MOE, window=16), 2
    ),
    moe=MoEConfig(n_experts=4, top_k=2),
    max_seq_len=128,
    sub_quadratic=True,
)

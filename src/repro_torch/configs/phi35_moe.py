"""phi3.5-moe-42b-a6.6b [moe]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=6400,
vocab=32064. MoE 16 experts top-2, full attention.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.models.config import (
    ArchConfig, BlockSpec, FF, Mixer, MoEConfig, uniform_groups,
)

_SB = BlockSpec(Mixer.GLOBAL_ATTN, FF.MOE)

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    groups=uniform_groups(_SB, 32),
    moe=MoEConfig(n_experts=16, top_k=2),
    sub_quadratic=False,  # full attention -> long_500k skipped
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    groups=uniform_groups(_SB, 2),
    moe=MoEConfig(n_experts=4, top_k=2),
    max_seq_len=128,
    sub_quadratic=False,
)

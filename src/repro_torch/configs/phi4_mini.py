"""phi4-mini-3.8b [dense]: 32L, d_model=3072, 24H (GQA kv=8), d_ff=8192,
vocab=200064. RoPE + SwiGLU + GQA. [arXiv:2412.08905; hf]"""

from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer, uniform_groups

_SB = BlockSpec(Mixer.GLOBAL_ATTN, FF.SWIGLU)

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    groups=uniform_groups(_SB, 32),
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke",
    family="dense",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    groups=uniform_groups(_SB, 2),
    max_seq_len=128,
    sub_quadratic=False,
)

"""qwen1.5-32b [dense]: 64L, d_model=5120, 40H (MHA kv=40), d_ff=27392,
vocab=152064. QKV bias (the Qwen1.5 signature), RoPE, SwiGLU.
[hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer, uniform_groups

_SB = BlockSpec(Mixer.GLOBAL_ATTN, FF.SWIGLU)

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    groups=uniform_groups(_SB, 64),
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="qwen1.5-smoke",
    family="dense",
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    groups=uniform_groups(_SB, 2),
    max_seq_len=128,
    sub_quadratic=False,
)

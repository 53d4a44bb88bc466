"""starcoder2-7b [dense]: 32L, d_model=4608, 36H (GQA kv=4), d_ff=18432,
vocab=49152. GQA + RoPE; plain GELU MLP + LayerNorm (starcoder2 family).
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer, uniform_groups

_SB = BlockSpec(Mixer.GLOBAL_ATTN, FF.GELU)

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    norm="layernorm",
    groups=uniform_groups(_SB, 32),
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    norm="layernorm",
    groups=uniform_groups(_SB, 2),
    max_seq_len=128,
    sub_quadratic=False,
)

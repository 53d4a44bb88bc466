"""gemma3-12b [dense]: 48L, d_model=3840, 16H (GQA kv=8), d_ff=15360,
vocab=262144. 5:1 local:global attention (window 1024, RoPE base 10k local /
1M global), 128k context, head_dim=256, GeGLU.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer, pattern_groups

_LOCAL = BlockSpec(Mixer.LOCAL_ATTN, FF.GEGLU, window=1024, rope_base=10_000.0)
_GLOBAL = BlockSpec(Mixer.GLOBAL_ATTN, FF.GEGLU, rope_base=1_000_000.0)
_PATTERN = (_LOCAL,) * 5 + (_GLOBAL,)  # 5:1, 48 layers = 8 superblocks

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    head_dim=256,
    groups=pattern_groups(_PATTERN, 48),
    max_seq_len=131_072,
    # SWA-dominant (5/6 of layers); global layers are O(S) per decode step
    sub_quadratic=True,
)

_SM_PATTERN = (
    BlockSpec(Mixer.LOCAL_ATTN, FF.GEGLU, window=16, rope_base=10_000.0),
    BlockSpec(Mixer.GLOBAL_ATTN, FF.GEGLU, rope_base=1_000_000.0),
)

SMOKE = ArchConfig(
    name="gemma3-smoke",
    family="dense",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    groups=pattern_groups(_SM_PATTERN, 4),
    max_seq_len=128,
    sub_quadratic=True,
)

"""xlstm-1.3b [ssm]: 48 blocks, d_model=2048, 4H, vocab=50304, d_ff=0
(blocks carry internal up/down projections). 7:1 mLSTM:sLSTM pattern
(xLSTM[7:1]); 48 = 6 superblocks of (7 mLSTM + 1 sLSTM).
[arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer, pattern_groups

_M = BlockSpec(Mixer.MLSTM, FF.NONE, rope_base=None)
_S = BlockSpec(Mixer.SLSTM, FF.NONE, rope_base=None)
_PATTERN = (_M,) * 7 + (_S,)

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    groups=pattern_groups(_PATTERN, 48),
    max_seq_len=1_048_576,  # constant-size recurrent state
    sub_quadratic=True,
    # pf=1.0 puts per-block params at ~6*d^2 -> 1.33B total, matching the
    # 1.3b nameplate (xLSTM's pf=2 with low-rank qk would need rank plumbing)
    lstm_proj_factor=1.0,
)

SMOKE = ArchConfig(
    name="xlstm-smoke",
    family="ssm",
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    groups=pattern_groups((_M, _S), 2),
    max_seq_len=128,
    sub_quadratic=True,
    lstm_proj_factor=2.0,
)

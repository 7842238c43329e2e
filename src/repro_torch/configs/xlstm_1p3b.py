"""xlstm-1.3b [ssm] — alternating mLSTM / sLSTM blocks [arXiv:2405.04517].
d_ff=0: xLSTM blocks carry their projections internally. 4 heads with large
per-head state (mLSTM matrix memory)."""
from .base import ModelConfig, MLSTM, SLSTM

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=(MLSTM, SLSTM),
    ssm_expand=2,
    ssm_chunk=128,
    citation="arXiv:2405.04517",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 512),
        ("num_heads", 4), ("num_kv_heads", 4),
    ),
)

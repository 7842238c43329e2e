"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    citation="arXiv:2403.04652",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 4), ("d_ff", 2816),
    ),
)

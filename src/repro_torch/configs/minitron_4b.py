"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    citation="arXiv:2407.14679",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 4), ("d_ff", 2816),
    ),
)

"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    rope_theta=10000.0,
    citation="arXiv:2412.08905",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 4), ("d_ff", 2816),
    ),
)

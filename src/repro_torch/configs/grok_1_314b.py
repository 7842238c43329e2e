"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

Optimizer moments in bf16 (opt_state_dtype): at 314B params fp32 m/v would
not fit the 16 GB/chip HBM budget on the 256-chip pod (DESIGN.md §6).
Draft model is dense."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    num_experts_per_tok=2,
    attn_softcap=30.0,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    citation="hf:xai-org/grok-1",
    drafter_overrides=(
        ("num_layers", 6), ("d_model", 2048), ("num_heads", 16),
        ("num_kv_heads", 8), ("d_ff", 5632),
        ("num_experts", 0), ("num_experts_per_tok", 0),
        ("param_dtype", "float32"), ("opt_state_dtype", "float32"),
    ),
)

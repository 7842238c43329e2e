"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base family]. (The assignment header
says "MoE 40e top-8"; the bracketed 1b card has 32 experts — we follow the
primary 40e spec.) Draft model is dense (DESIGN.md §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    num_experts=40,
    num_experts_per_tok=8,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 512), ("num_heads", 8),
        ("num_kv_heads", 4), ("head_dim", 64), ("d_ff", 1408),
        ("num_experts", 0), ("num_experts_per_tok", 0),
    ),
)

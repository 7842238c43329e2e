"""Llama 2-Chat 7B — the paper's own target model (paper Table 1; standard
Llama-2 7B dims). The drafter overrides reproduce Llama 2-Chat-Drafter-115M:
4 layers, 8 heads, hidden 1024, intermediate 2816, SiLU — 1.64% of target."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b-chat",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    head_dim=128,
    citation="arXiv:2307.09288; paper Table 1",
    drafter_overrides=(
        ("name", "llama2-chat-drafter-115m"),
        ("num_layers", 4), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 8), ("d_ff", 2816),
    ),
)

DRAFTER = CONFIG.drafter()

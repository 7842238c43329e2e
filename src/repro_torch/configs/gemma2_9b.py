"""gemma2-9b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118]. head_dim=256 (q/k/v dim 4096 != d_model, per model card);
embeddings scaled by sqrt(d_model)."""
from .base import ModelConfig, ATTN, LOCAL_ATTN

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=(LOCAL_ATTN, ATTN),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    rope_theta=10000.0,
    citation="arXiv:2408.00118",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 4), ("head_dim", 128), ("d_ff", 2816),
    ),
)

"""zamba2-7b [hybrid] — Mamba2 backbone with shared attention(+MLP) blocks
[arXiv:2411.15242]. 81 total blocks: repeating group of 6 Mamba2 blocks
followed by one shared-weight attention block (2 weight sets used
round-robin), remainder Mamba2. ssm_state=64."""
from .base import ModelConfig, MAMBA, SHARED_ATTN

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    layer_pattern=(MAMBA,) * 6 + (SHARED_ATTN,),
    shared_attn_period=6,
    num_shared_attn_sets=2,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    citation="arXiv:2411.15242",
    drafter_overrides=(
        ("num_layers", 7), ("d_model", 1024), ("num_heads", 8),
        ("num_kv_heads", 8), ("head_dim", 128), ("d_ff", 2816),
        ("layer_pattern", (MAMBA,) * 2 + (SHARED_ATTN,)),
        ("shared_attn_period", 2),
    ),
)

"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. 4 codebooks x vocab 2048, embeddings summed over
codebooks, one output head per codebook (flattened-sum interleave of the
delay pattern, DESIGN.md §4). The EnCodec conv codec is the allowed stub:
``input_specs`` provides (B, K, S) token ids."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    num_codebooks=4,
    citation="arXiv:2306.05284",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 512), ("num_heads", 8),
        ("num_kv_heads", 8), ("d_ff", 1408),
    ),
)

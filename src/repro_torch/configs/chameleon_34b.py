"""chameleon-34b [vlm] — early-fusion over VQ image tokens [arXiv:2405.09818].

The modality frontend (VQ-VAE image tokenizer) is the allowed stub: image
patches arrive as discrete ids inside the shared 65536 vocab, so
``input_specs`` provides plain token ids for mixed-modality sequences.
qk-norm per the paper's training-stability fix."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    citation="arXiv:2405.09818",
    drafter_overrides=(
        ("num_layers", 4), ("d_model", 1536), ("num_heads", 12),
        ("num_kv_heads", 4), ("d_ff", 4096),
    ),
)

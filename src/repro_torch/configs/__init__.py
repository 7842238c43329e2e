"""Config registry of the port: the 10 assigned architectures (+ the
paper's own Llama 2-Chat target/drafter pair), selectable via
``--arch <id>`` (``repro.configs``).

Every config is registered and every one constructs; ``INPUT_SHAPES``
holds the dry run's four assigned shapes (``launch.dryrun``)."""
from __future__ import annotations

from typing import Dict

from .base import (ATTN, INPUT_SHAPES, LOCAL_ATTN, MAMBA,  # noqa: F401
                   MLSTM, SHARED_ATTN, SLSTM, ModelConfig, QuantConfig,
                   ShapeConfig, TrainConfig)
from . import (phi4_mini_3p8b, gemma2_9b, zamba2_7b, granite_moe_3b,
               minitron_4b, chameleon_34b, grok_1_314b, yi_9b, xlstm_1p3b,
               musicgen_large, llama2_7b_chat)

ARCHS: Dict[str, ModelConfig] = {
    "phi4-mini-3.8b": phi4_mini_3p8b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "xlstm-1.3b": xlstm_1p3b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    # the paper's own pair (not part of the assigned 10)
    "llama2-7b-chat": llama2_7b_chat.CONFIG,
    "llama2-chat-drafter-115m": llama2_7b_chat.DRAFTER,
}

ASSIGNED = tuple(list(ARCHS)[:10])


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")


def reduced(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests: one pattern group
    (>=2 layers), d_model<=256, <=4 experts."""
    g = cfg.layer_pattern
    layers = len(g) if len(g) > 1 else 2
    d = 128
    heads = 4
    kvh = max(1, min(cfg.num_kv_heads, heads // max(1, cfg.q_per_kv)))
    over = dict(
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kvh if heads % kvh == 0 else heads,
        head_dim=d // heads if cfg.head_dim else 0,
        d_ff=0 if cfg.d_ff == 0 else 2 * d,
        vocab_size=min(cfg.vocab_size, vocab),
        attn_chunk=32,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 32),
        long_context_window=64,
        ssm_state_dim=min(cfg.ssm_state_dim, 16) if cfg.ssm_state_dim else 0,
        ssm_head_dim=32,
        remat=False,
    )
    if cfg.is_moe:
        over.update(num_experts=4, num_experts_per_tok=2, d_ff=2 * d)
    if cfg.shared_attn_period:
        over.update(layer_pattern=(MAMBA, MAMBA, SHARED_ATTN),
                    shared_attn_period=2, num_layers=3)
    return cfg.replace(**over)

"""Config registry of the port: the paper's Llama 2-Chat target/drafter
pair, selectable via ``--arch <id>``."""
from __future__ import annotations

from typing import Dict

from . import llama2_7b_chat
from .base import ATTN, LOCAL_ATTN, ModelConfig  # noqa: F401

ARCHS: Dict[str, ModelConfig] = {
    "llama2-7b-chat": llama2_7b_chat.CONFIG,
    "llama2-chat-drafter-115m": llama2_7b_chat.DRAFTER,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests, equal to
    ``repro.configs.reduced`` on the fields the port has."""
    g = cfg.layer_pattern
    d, heads = 128, 4
    kvh = max(1, min(cfg.num_kv_heads, heads // max(1, cfg.q_per_kv)))
    return cfg.replace(
        name=cfg.name + "-reduced",
        num_layers=len(g) if len(g) > 1 else 2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kvh if heads % kvh == 0 else heads,
        head_dim=d // heads if cfg.head_dim else 0,
        d_ff=0 if cfg.d_ff == 0 else 2 * d,
        vocab_size=min(cfg.vocab_size, 512),
        attn_chunk=32,
    )

"""Public model API (``repro.models.model``): a thin wrapper binding a
``ModelConfig`` to a device."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import transformer as tfm


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


class Model:
    """Entry points run on the card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int):
        """Seeded random parameters (``transformer.init_params``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_params(gen, self.cfg, self.device)

    def init_cache(self, batch: int, max_len: int):
        return tfm.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, cache_len: int, positions=None):
        """tokens (B, S) -> (logits of the last position (B, 1, V) fp32,
        caches of ``cache_len`` slots)."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="prefill",
                                positions=positions, cache_len=cache_len)
        return tfm.logits_from_hidden(params, h[:, -1:], self.cfg), cache

    def decode_step(self, params, tokens, positions, cache, slots=None,
                    attn_mask=None):
        """tokens (B, T) new ids, positions (B, T) absolute -> (logits
        (B, T, V) fp32, cache). ``slots``/``attn_mask`` serve tree
        speculation: storage slots for nodes that share a RoPE position, and
        an ancestor mask replacing positional causality."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="decode",
                                positions=positions, cache=cache,
                                slots=slots, attn_mask=attn_mask)
        return tfm.logits_from_hidden(params, h, self.cfg), cache

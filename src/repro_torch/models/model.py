"""Public model API (``repro.models.model``): a thin wrapper binding a
``ModelConfig`` to a device.

``loss_ce`` computes next-token cross-entropy chunked over the sequence, as
the reference does: the lm-head matmul and softmax of one chunk of
``LOSS_CHUNK`` positions run under ``torch.utils.checkpoint``, so the full
(B, S, V) fp32 logits never exist at once and backward recomputes each
chunk's logits instead of storing them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import transformer as tfm

LOSS_CHUNK = 512


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


def chunked_ce_from_hidden(params, hidden, labels, cfg):
    """hidden (B, S, D), labels (B, S) int (-1 = masked) -> (sum of the
    token NLLs, count of labelled tokens). Single-codebook labels only."""
    if labels.dim() != 2:
        raise ValueError("only single-codebook (B, S) labels are ported, got "
                         f"{tuple(labels.shape)}")
    B, S, _ = hidden.shape
    C = LOSS_CHUNK if S % LOSS_CHUNK == 0 and S > LOSS_CHUNK else S

    def chunk(h, lab):
        logits = tfm.logits_from_hidden(params, h, cfg)          # fp32
        return F.cross_entropy(logits.flatten(0, 1), lab.flatten().long(),
                               ignore_index=-1, reduction="sum")

    sums = [checkpoint(chunk, hidden[:, i:i + C], labels[:, i:i + C],
                       use_reentrant=False) for i in range(0, S, C)]
    return torch.stack(sums).sum(), (labels >= 0).sum()


class Model:
    """Entry points run on the card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int, dtype=None):
        """Seeded random parameters (``transformer.init_params``); matmul
        weights in ``dtype``, by default the compute dtype."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_params(gen, self.cfg, self.device, dtype)

    def init_cache(self, batch: int, max_len: int, kv_quant: bool = False):
        return tfm.init_cache(self.cfg, batch, max_len, self.device, kv_quant)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_quant: bool = False):
        """Shared paged KV pool (serving.kv_pool); ``kv_quant`` = int8
        pages with per-slot scales."""
        return tfm.init_paged_cache(self.cfg, num_pages, page_size,
                                    self.device, kv_quant)

    def hidden(self, params, tokens):
        """tokens (B, S) -> final hidden states (B, S, D) of a training
        forward (no caches). The reference also returns an MoE aux loss,
        always 0 for the dense models the port has."""
        return tfm.backbone(params, tokens, self.cfg, mode="train")[0]

    def logits(self, params, tokens):
        return tfm.logits_from_hidden(params, self.hidden(params, tokens),
                                      self.cfg)

    def loss_ce(self, params, tokens, labels):
        """Mean next-token CE; tokens/labels already shifted. Returns
        (loss, {"ce": loss})."""
        s, c = chunked_ce_from_hidden(params, self.hidden(params, tokens),
                                      labels, self.cfg)
        loss = s / c.clamp(min=1)
        return loss, {"ce": loss}

    def prefill(self, params, tokens, cache_len: int, positions=None):
        """tokens (B, S) -> (logits of the last position (B, 1, V) fp32,
        caches of ``cache_len`` slots)."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="prefill",
                                positions=positions, cache_len=cache_len)
        return tfm.logits_from_hidden(params, h[:, -1:], self.cfg), cache

    def decode_step(self, params, tokens, positions, cache, slots=None,
                    attn_mask=None, page_table=None):
        """tokens (B, T) new ids, positions (B, T) absolute -> (logits
        (B, T, V) fp32, cache). ``slots``/``attn_mask`` serve tree
        speculation: storage slots for nodes that share a RoPE position, and
        an ancestor mask replacing positional causality. With
        ``page_table`` (B, max_pages) the attention layers read and write
        the shared paged pool (``init_paged_cache``) instead of per-row
        caches."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="decode",
                                positions=positions, cache=cache,
                                slots=slots, attn_mask=attn_mask,
                                page_table=page_table)
        return tfm.logits_from_hidden(params, h, self.cfg), cache

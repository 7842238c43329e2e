"""Public model API (``repro.models.model``): a thin wrapper binding a
``ModelConfig`` to a device.

``loss_ce`` computes next-token cross-entropy chunked over the sequence, as
the reference does: the lm-head matmul and softmax of one chunk of
``LOSS_CHUNK`` positions run under ``torch.utils.checkpoint``, so the full
(B, S, V) fp32 logits never exist at once and backward recomputes each
chunk's logits instead of storing them.

``capture_hidden`` is the draft heads' tap (``repro_torch.draftheads``):
while its scope is open, every ``Model.hidden``/``logits`` call records its
final hidden states into the innermost scope's box, so head training gets
the teacher's logits and features from one target forward. The reference
taps at trace time inside jit; here the tap is eager and the box holds the
tensor itself.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import transformer as tfm

LOSS_CHUNK = 512

# boxes of the open ``capture_hidden`` scopes, innermost last
_HIDDEN_TAPS: list = []  # repolint: ignore[RL003] the tap stack, scoped by the capture_hidden contextmanager


@contextmanager
def capture_hidden():
    """``with capture_hidden() as box: target.logits(...)`` leaves the
    (B, S, D) final hidden states of that call in ``box["hidden"]``."""
    box: dict = {}
    _HIDDEN_TAPS.append(box)
    try:
        yield box
    finally:
        _HIDDEN_TAPS.remove(box)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


def chunked_ce_from_hidden(params, hidden, labels, cfg):
    """hidden (B, S, D), labels (B, S) or, multi-codebook, (B, K, S) int
    (-1 = masked) -> (sum of the token NLLs, count of labelled tokens). A
    chunk's (B, K, C) labels are moved to (B, C, K), against its (B, C, K,
    V) logits."""
    B, S, _ = hidden.shape
    C = LOSS_CHUNK if S % LOSS_CHUNK == 0 and S > LOSS_CHUNK else S
    multi = labels.dim() == 3

    def chunk(h, lab):
        logits = tfm.logits_from_hidden(params, h, cfg)          # fp32
        if multi:
            lab = lab.transpose(1, 2)
        return F.cross_entropy(logits.flatten(0, -2), lab.flatten().long(),
                               ignore_index=-1, reduction="sum")

    sums = [checkpoint(chunk, hidden[:, i:i + C], labels[..., i:i + C],
                       use_reentrant=False) for i in range(0, S, C)]
    return torch.stack(sums).sum(), (labels >= 0).sum()


class Model:
    """Entry points run on the card unless ``device="cpu"`` is passed; on
    ``device="meta"`` ``init`` and the caches have shapes and dtypes only
    (``launch.dryrun``). A layer kind the port does not know is refused by
    ``init``, ``init_cache`` and ``init_paged_cache``, with the
    ``ValueError`` of ``transformer.check_config``. A multi-codebook model
    takes (B, K, S) ids everywhere a single-codebook one takes (B, S), and
    its logits carry a K axis before V."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int, dtype=None):
        """Seeded random parameters (``transformer.init_params``); matmul
        weights in ``dtype``, by default the compute dtype. On the meta
        device nothing is drawn and no generator is built."""
        gen = (None if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(seed))
        return tfm.init_params(gen, self.cfg, self.device, dtype)

    def init_cache(self, batch: int, max_len: int, long_context: bool = False,
                   kv_quant: bool = False):
        """Per-layer caches: an attention layer's KV cache (a windowed
        layer's is a ring of ``min(max_len, window)`` slots), a recurrent
        layer's zero state."""
        return tfm.init_cache(self.cfg, batch, max_len, self.device,
                              long_context, kv_quant)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_quant: bool = False):
        """Shared paged KV pool (serving.kv_pool); ``kv_quant`` = int8
        pages with per-slot scales."""
        return tfm.init_paged_cache(self.cfg, num_pages, page_size,
                                    self.device, kv_quant)

    def hidden_and_aux(self, params, tokens, with_aux: bool = True):
        """tokens (B, S) -> (final hidden states (B, S, D) of a training
        forward (no caches), the MoE router aux summed over the layers;
        float32, 0 for a dense model): the pair the reference's ``hidden``
        returns. Without ``with_aux`` the aux is not computed (None)."""
        h, aux = tfm.backbone(params, tokens, self.cfg, mode="train",
                              with_aux=with_aux)
        if _HIDDEN_TAPS:
            _HIDDEN_TAPS[-1]["hidden"] = h
        return h, aux

    def hidden(self, params, tokens):
        """The hidden states of ``hidden_and_aux``, the aux not computed."""
        return self.hidden_and_aux(params, tokens, with_aux=False)[0]

    def logits(self, params, tokens):
        return tfm.logits_from_hidden(params, self.hidden(params, tokens),
                                      self.cfg)

    def loss_ce(self, params, tokens, labels):
        """Mean next-token CE plus ``router_aux_weight`` times the MoE aux;
        tokens/labels already shifted. Returns (loss, {"ce": the CE, "aux":
        the aux})."""
        h, aux = self.hidden_and_aux(params, tokens)
        s, c = chunked_ce_from_hidden(params, h, labels, self.cfg)
        ce = s / c.clamp(min=1)
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, cache_len: int,
                long_context: bool = False, positions=None,
                return_hidden: bool = False):
        """tokens (B, S) or (B, K, S) -> (logits of the last position
        (B, 1, V) or (B, 1, K, V) fp32, caches of ``cache_len`` slots),
        plus the (B, S, D) final hidden states with ``return_hidden``
        (draft heads seed their feature from the last prompt position).
        ``long_context`` windows the global layers at
        ``cfg.long_context_window``."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="prefill",
                                positions=positions, cache_len=cache_len,
                                long_context=long_context)
        logits = tfm.logits_from_hidden(params, h[:, -1:], self.cfg)
        return (logits, cache, h) if return_hidden else (logits, cache)

    def decode_step(self, params, tokens, positions, cache,
                    long_context: bool = False, slots=None, attn_mask=None,
                    page_table=None, return_hidden: bool = False):
        """tokens (B, T) new ids (or (B, K, T): K ids a step), positions
        (B, T) absolute -> (logits (B, T, V) or (B, T, K, V) fp32, cache),
        plus the (B, T, D) final hidden states the logits came from with
        ``return_hidden`` (the verify pass hands them to draft heads).
        ``slots``/``attn_mask`` serve tree speculation: storage slots for
        nodes that share a RoPE position, and an ancestor mask replacing
        positional causality. With ``page_table`` (B,
        max_pages) the attention layers read and write the shared paged
        pool (``init_paged_cache``) instead of per-row caches.
        ``long_context`` windows the global layers as in ``prefill``."""
        h, cache = tfm.backbone(params, tokens, self.cfg, mode="decode",
                                positions=positions, cache=cache,
                                long_context=long_context,
                                slots=slots, attn_mask=attn_mask,
                                page_table=page_table)
        logits = tfm.logits_from_hidden(params, h, self.cfg)
        return (logits, cache, h) if return_hidden else (logits, cache)

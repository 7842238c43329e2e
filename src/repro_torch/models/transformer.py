"""The dense decoder stack (``repro.models.transformer``):
``embed -> layers -> final_norm -> lm_head``.

The reference stacks each group's parameters on a leading layer axis and
scans over it; the port keeps one parameter dict and one cache dict per
layer, in ``params["layers"]`` and a list of caches, and loops over them.
Only the ``attn`` layer kind is ported.
"""
from __future__ import annotations

import torch

from ..configs.base import ATTN
from . import attention as attn_mod
from .layers import (dense_param, embed_tokens, lm_head_logits, rms_norm,
                     swiglu, trunc_normal)


def _check_pattern(cfg):
    g, _, rem = cfg.pattern_blocks()
    kinds = set(g) | set(rem)
    if kinds != {ATTN}:
        raise ValueError(f"{cfg.name}: only '{ATTN}' layers are ported, got "
                         f"{sorted(kinds)}")
    if cfg.d_ff <= 0:
        raise ValueError(f"{cfg.name}: the port needs an FFN (d_ff > 0)")


def init_params(gen, cfg, device):
    """Seeded random parameters drawn from ``gen`` on ``device``: matmul
    weights in the compute dtype, norm weights in float32 (zeros)."""
    _check_pattern(cfg)
    wdt = cfg.compute_dtype
    d, hd, f = cfg.d_model, cfg.head_dim_, cfg.d_ff

    def norm():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def dense(i, o):
        return dense_param(gen, i, o, wdt, device)

    params = {"embed": trunc_normal(gen, (cfg.vocab_size, d), 1.0, wdt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_param(gen, d, cfg.vocab_size, wdt, device)
    params["final_norm"] = norm()
    params["layers"] = [
        {"norm1": norm(),
         "attn": {"wq": dense(d, cfg.num_heads * hd),
                  "wk": dense(d, cfg.num_kv_heads * hd),
                  "wv": dense(d, cfg.num_kv_heads * hd),
                  "wo": dense(cfg.num_heads * hd, d)},
         "norm2": norm(),
         "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f),
                 "w_down": dense(f, d)}}
        for _ in range(cfg.num_layers)]
    return params


def init_cache(cfg, batch, max_len, device):
    """One empty KV cache dict per layer (positions -1 = empty slot)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device)}
            for _ in range(cfg.num_layers)]


def backbone(params, tokens, cfg, mode, positions=None, cache=None,
             cache_len=0, slots=None, attn_mask=None):
    """tokens: (B, S) int. ``mode`` is "prefill" (builds caches of
    ``cache_len`` slots) or "decode" (writes into ``cache``).
    Returns (hidden (B, S, D) after the final norm, caches)."""
    x = embed_tokens(params["embed"], tokens).to(cfg.compute_dtype)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    caches = []
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mode == "prefill":
            y, c = attn_mod.prefill_attention(lp["attn"], h, positions, cfg,
                                              cache_len)
        elif mode == "decode":
            y, c = attn_mod.decode_attention(lp["attn"], h, cache[i],
                                             positions, cfg, slots=slots,
                                             attn_mask=attn_mask)
        else:
            raise ValueError(f"mode {mode!r} is not ported")
        x = x + y
        x = x + swiglu(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps))
        caches.append(c)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def logits_from_hidden(params, hidden, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lm_head_logits(w, hidden, cfg.final_softcap)

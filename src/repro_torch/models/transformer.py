"""The dense decoder stack (``repro.models.transformer``):
``embed -> layers -> final_norm -> lm_head``.

The reference stacks each group's parameters on a leading layer axis and
scans over it; the port keeps one parameter dict and one cache dict per
layer, in ``params["layers"]`` and a list of caches, and loops over them.
Only the ``attn`` layer kind is ported, with qk-norm and softcaps;
``check_config`` refuses every other kind and feature of the registry,
naming the ROADMAP item (queue 1) that ports it, so that no config runs
with a feature silently dropped.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN, LOCAL_ATTN, MAMBA, MLSTM, SHARED_ATTN, SLSTM
from . import attention as attn_mod
from .layers import (dense_param, embed_tokens, lm_head_logits, rms_norm,
                     swiglu, trunc_normal)


# ROADMAP.md queue 1 items that port what the decoder refuses
_GEMMA2 = "ROADMAP §1 item 2 (sliding windows and long context, gemma2-9b)"
_CODEBOOKS = ("ROADMAP §1 item 3 (multi-codebook embeddings, heads and loss, "
              "musicgen-large with K 4)")
_MOE = "ROADMAP §1 item 4 (mixture of experts)"
_RECURRENT = "ROADMAP §1 item 5 (recurrent layers and hybrids)"
_ITEM_OF_KIND = {LOCAL_ATTN: _GEMMA2, MAMBA: _RECURRENT, MLSTM: _RECURRENT,
                 SLSTM: _RECURRENT, SHARED_ATTN: _RECURRENT}


def check_config(cfg):
    """Raise ``ValueError`` naming the ROADMAP item of the first layer kind
    or feature of ``cfg`` that the port does not run yet: ``local_attn`` or
    ``scale_embed``, experts, recurrent and shared-attention layers, more
    than one codebook. Softcaps and qk-norm are ported."""
    g, _, rem = cfg.pattern_blocks()
    refused = [(f"the '{kind}' layer kind", _ITEM_OF_KIND.get(kind, "no item"))
               for kind in tuple(g) + tuple(rem) if kind != ATTN]
    refused += [(what, item) for on, what, item in (
        (cfg.scale_embed, "scale_embed (embeddings times sqrt(d))", _GEMMA2),
        (cfg.is_moe, f"mixture of experts ({cfg.num_experts} experts)", _MOE),
        (cfg.num_codebooks > 1,
         f"multi-codebook input ({cfg.num_codebooks} codebooks)", _CODEBOOKS))
        if on]
    if refused:
        what, item = refused[0]
        raise ValueError(f"{cfg.name}: {what} is not ported yet; it waits "
                         f"for {item}")
    if cfg.d_ff <= 0:
        raise ValueError(f"{cfg.name}: the port needs an FFN (d_ff > 0)")


def init_params(gen, cfg, device, dtype=None):
    """Seeded random parameters drawn from ``gen`` on ``device``: matmul
    weights in ``dtype`` (default: the compute dtype, for serving; training
    passes ``cfg.param_dtype``), norm weights in float32 (zeros)."""
    check_config(cfg)
    wdt = dtype or cfg.compute_dtype
    d, hd, f = cfg.d_model, cfg.head_dim_, cfg.d_ff

    def norm(n=d):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def dense(i, o):
        return dense_param(gen, i, o, wdt, device)

    def attn():
        p = {"wq": dense(d, cfg.num_heads * hd),
             "wk": dense(d, cfg.num_kv_heads * hd),
             "wv": dense(d, cfg.num_kv_heads * hd),
             "wo": dense(cfg.num_heads * hd, d)}
        if cfg.qk_norm:     # RMSNorm weights of q and k, shared by the heads
            p["q_norm"], p["k_norm"] = norm(hd), norm(hd)
        return p

    params = {"embed": trunc_normal(gen, (cfg.vocab_size, d), 1.0, wdt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_param(gen, d, cfg.vocab_size, wdt, device)
    params["final_norm"] = norm()
    params["layers"] = [
        {"norm1": norm(),
         "attn": attn(),
         "norm2": norm(),
         "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f),
                 "w_down": dense(f, d)}}
        for _ in range(cfg.num_layers)]
    return params


def init_cache(cfg, batch, max_len, device, kv_quant=False):
    """One empty KV cache dict per layer (positions -1 = empty slot).
    ``kv_quant`` builds the int8 layout (``quant.kvcache``): int8 k/v plus
    fp32 per-(slot, head) "k_scale"/"v_scale" of shape (B, S, Hkv)."""
    check_config(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    caches = []
    for _ in range(cfg.num_layers):
        c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device),
             "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device)}
        if kv_quant:
            c["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
            c["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        caches.append(c)
    return caches


def init_paged_cache(cfg, num_pages, page_size, device, kv_quant=False):
    """One paged KV pool dict per layer (``repro.models.transformer
    .init_paged_cache``): {"k", "v": (P, page, Hkv, hd), "page_pos": (P,
    page)}, no batch axis; rows share the pool through a page table
    (serving.kv_pool), and physical page 0 is the null page. ``kv_quant``
    stores int8 k/v plus fp32 per-(page slot, head) "k_scale"/"v_scale".

    The pool is zeroed, not left uninitialised: every row's gathered view
    holds null-page and never-written slots at probability 0, and a
    non-finite value there would turn 0 * V into NaN."""
    check_config(cfg)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    pools = []
    for _ in range(cfg.num_layers):
        c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device),
             "page_pos": torch.full((num_pages, page_size), -1,
                                    dtype=torch.int32, device=device)}
        if kv_quant:
            c["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
            c["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        pools.append(c)
    return pools


def _train_layer(lp, x, positions, cfg):
    x = x + attn_mod.causal_attention(lp["attn"], rms_norm(x, lp["norm1"],
                                                           cfg.norm_eps),
                                      positions, cfg)
    return x + swiglu(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps))


def backbone(params, tokens, cfg, mode, positions=None, cache=None,
             cache_len=0, slots=None, attn_mask=None, page_table=None):
    """tokens: (B, S) int. ``mode`` is "train" (no caches), "prefill"
    (builds caches of ``cache_len`` slots) or "decode" (writes into
    ``cache``; with ``page_table`` (B, max_pages) the cache is the shared
    paged pool of ``init_paged_cache``). Returns (hidden (B, S, D) after the final norm, caches;
    None in training).

    In training with ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint`` while gradients are recorded, so backward
    recomputes its activations (the reference's ``jax.checkpoint`` of the
    layer scan)."""
    x = embed_tokens(params["embed"], tokens).to(cfg.compute_dtype)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if mode == "train":
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in params["layers"]:
            if remat:
                x = checkpoint(_train_layer, lp, x, positions, cfg,
                               use_reentrant=False)
            else:
                x = _train_layer(lp, x, positions, cfg)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), None
    caches = []
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mode == "prefill":
            y, c = attn_mod.prefill_attention(lp["attn"], h, positions, cfg,
                                              cache_len)
        elif mode == "decode" and page_table is not None:
            y, c = attn_mod.paged_decode_attention(
                lp["attn"], h, cache[i], page_table, positions, cfg,
                slots=slots, attn_mask=attn_mask)
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

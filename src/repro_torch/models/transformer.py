"""The dense decoder stack (``repro.models.transformer``):
``embed -> layers -> final_norm -> lm_head``.

The reference stacks each group's parameters on a leading layer axis and
scans over it; the port keeps one parameter dict and one cache dict per
layer, in ``params["layers"]`` and a list of caches, and loops over them.
Layer i is of kind ``layer_kinds(cfg)[i]``: the repeating pattern r-major,
then the remainder, the order in which ``bridge.params_from_jax`` unstacks
the reference's groups. The ``attn`` and ``local_attn`` kinds are ported,
with qk-norm, softcaps, sliding windows, long-context windows and scaled
embeddings (Gemma-2), and a layer's FFN is a SwiGLU or, in an MoE config,
the experts of ``models.moe`` under ``"moe"``; ``check_config`` refuses
every other kind and feature of the registry, naming the ROADMAP item
(queue 1) that ports it, so that no config runs with a feature silently
dropped.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN, LOCAL_ATTN, MAMBA, MLSTM, SHARED_ATTN, SLSTM
from . import attention as attn_mod
from .layers import (dense_param, embed_tokens, lm_head_logits, rms_norm,
                     swiglu, trunc_normal)
from .moe import init_moe, moe_ffn


# ROADMAP.md queue 1 items that port what the decoder refuses
_CODEBOOKS = ("ROADMAP §1 item 3 (multi-codebook embeddings, heads and loss, "
              "musicgen-large with K 4)")
_RECURRENT = "ROADMAP §1 item 5 (recurrent layers and hybrids)"
_ITEM_OF_KIND = {MAMBA: _RECURRENT, MLSTM: _RECURRENT, SLSTM: _RECURRENT,
                 SHARED_ATTN: _RECURRENT}
_ATTN_KINDS = (ATTN, LOCAL_ATTN)


def check_config(cfg):
    """Raise ``ValueError`` naming the ROADMAP item of the first layer kind
    or feature of ``cfg`` that the port does not run yet: recurrent and
    shared-attention layers, more than one codebook. Softcaps, qk-norm,
    ``local_attn`` layers, ``scale_embed`` and experts are ported."""
    g, _, rem = cfg.pattern_blocks()
    refused = [(f"the '{kind}' layer kind", _ITEM_OF_KIND.get(kind, "no item"))
               for kind in tuple(g) + tuple(rem) if kind not in _ATTN_KINDS]
    if cfg.num_codebooks > 1:
        refused.append((f"multi-codebook input ({cfg.num_codebooks} "
                        "codebooks)", _CODEBOOKS))
    if refused:
        what, item = refused[0]
        raise ValueError(f"{cfg.name}: {what} is not ported yet; it waits "
                         f"for {item}")
    if cfg.d_ff <= 0:
        raise ValueError(f"{cfg.name}: the port needs an FFN (d_ff > 0)")


def layer_kinds(cfg):
    """The kind of every layer in order: the pattern r-major, then the
    remainder."""
    g, n, rem = cfg.pattern_blocks()
    return tuple(g) * n + tuple(rem)


def _block_window(cfg, kind, long_context):
    """The attention window of a layer of ``kind``, or None (the
    reference's ``_block_window``)."""
    if kind == LOCAL_ATTN:
        return cfg.sliding_window
    if long_context:           # dense fallback: windowed global attention
        return cfg.long_context_window
    return None


def layer_windows(cfg, long_context=False):
    """``_block_window`` of every layer in order."""
    return [_block_window(cfg, kind, long_context) for kind in layer_kinds(cfg)]


def init_params(gen, cfg, device, dtype=None):
    """Seeded random parameters drawn from ``gen`` on ``device``: matmul
    weights and expert banks in ``dtype`` (default: the compute dtype, for
    serving; training passes ``cfg.param_dtype``), norm weights in float32
    (zeros), an MoE router in float32."""
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

    def layer():
        lp = {"norm1": norm(), "attn": attn(), "norm2": norm()}
        if cfg.is_moe:
            lp["moe"] = init_moe(gen, cfg, wdt, device)
        else:
            lp["mlp"] = {"w_gate": dense(d, f), "w_up": dense(d, f),
                         "w_down": dense(f, d)}
        return lp

    params["layers"] = [layer() for _ in range(cfg.num_layers)]
    return params


def init_cache(cfg, batch, max_len, device, long_context=False,
               kv_quant=False):
    """One empty KV cache dict per layer (positions -1 = empty slot), of
    ``min(max_len, window)`` slots in a windowed layer (a ring) and
    ``max_len`` in the others. ``kv_quant`` builds the int8 layout
    (``quant.kvcache``): int8 k/v plus fp32 per-(slot, head)
    "k_scale"/"v_scale" of shape (B, S, Hkv)."""
    check_config(cfg)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    caches = []
    for window in layer_windows(cfg, long_context):
        size = min(max_len, window) if window else max_len
        shape = (batch, size, cfg.num_kv_heads, cfg.head_dim_)
        c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device),
             "pos": torch.full((batch, size), -1, dtype=torch.int32,
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
    Windowed layers get the same pool: pages keep every position, and the
    window only masks.

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


def _ffn(lp, x, cfg, with_aux=False):
    """The layer's FFN on its normed input x: (y, the MoE aux with
    ``with_aux``, else None; None for a SwiGLU)."""
    if "moe" in lp:
        return moe_ffn(lp["moe"], x, cfg, with_aux=with_aux)
    return swiglu(lp["mlp"], x), None


def _train_layer(lp, x, positions, cfg, window, with_aux):
    x = x + attn_mod.causal_attention(lp["attn"], rms_norm(x, lp["norm1"],
                                                           cfg.norm_eps),
                                      positions, cfg, window)
    y, aux = _ffn(lp, rms_norm(x, lp["norm2"], cfg.norm_eps), cfg, with_aux)
    return x + y, aux


def backbone(params, tokens, cfg, mode, positions=None, cache=None,
             long_context=False, cache_len=0, slots=None, attn_mask=None,
             page_table=None, with_aux=False):
    """tokens: (B, S) int. ``mode`` is "train" (no caches), "prefill"
    (builds caches of ``cache_len`` slots in every layer, as the
    reference does) or "decode" (writes into ``cache``; with
    ``page_table`` (B, max_pages) the cache is the shared paged pool of
    ``init_paged_cache``). Every mode attends within each layer's
    ``_block_window``; ``long_context`` windows the global layers too.
    With ``cfg.scale_embed`` the embeddings are multiplied by
    sqrt(d_model) in the compute dtype. Returns (hidden (B, S, D) after
    the final norm, caches); in training the second item is, with
    ``with_aux``, the MoE aux summed over the layers (float32, 0 for a
    dense model), else None: a forward that drops the aux does not compute
    it. Prefill and decode drop the aux, as the reference's do.

    In training with ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint`` while gradients are recorded, so backward
    recomputes its activations (the reference's ``jax.checkpoint`` of the
    layer scan)."""
    x = embed_tokens(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    B, S = tokens.shape
    windows = layer_windows(cfg, long_context)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if mode == "train":
        remat = cfg.remat and torch.is_grad_enabled()
        aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                     if with_aux else None)
        for lp, window in zip(params["layers"], windows):
            if remat:
                x, aux = checkpoint(_train_layer, lp, x, positions, cfg,
                                    window, with_aux, use_reentrant=False)
            else:
                x, aux = _train_layer(lp, x, positions, cfg, window, with_aux)
            if aux is not None:
                aux_total = aux_total + aux
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total
    caches = []
    for i, (lp, window) in enumerate(zip(params["layers"], windows)):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mode == "prefill":
            y, c = attn_mod.prefill_attention(lp["attn"], h, positions, cfg,
                                              cache_len, window)
        elif mode == "decode" and page_table is not None:
            y, c = attn_mod.paged_decode_attention(
                lp["attn"], h, cache[i], page_table, positions, cfg, window,
                slots=slots, attn_mask=attn_mask)
        elif mode == "decode":
            y, c = attn_mod.decode_attention(lp["attn"], h, cache[i],
                                             positions, cfg, window,
                                             slots=slots, attn_mask=attn_mask)
        else:
            raise ValueError(f"mode {mode!r} is not ported")
        x = x + y
        x = x + _ffn(lp, rms_norm(x, lp["norm2"], cfg.norm_eps), cfg)[0]
        caches.append(c)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def logits_from_hidden(params, hidden, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lm_head_logits(w, hidden, cfg.final_softcap)

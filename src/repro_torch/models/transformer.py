"""The decoder stack (``repro.models.transformer``):
``embed -> layers -> final_norm -> lm_head``.

The reference stacks each group's parameters on a leading layer axis and
scans over it; the port keeps one parameter dict and one cache dict per
layer, in ``params["layers"]`` and a list of caches, and loops over them.
Layer i is of kind ``layer_kinds(cfg)[i]``: the repeating pattern r-major,
then the remainder, the order in which ``bridge.params_from_jax`` unstacks
the reference's groups. Every kind of the registry runs: ``attn`` and
``local_attn`` (qk-norm, softcaps, sliding and long-context windows,
scaled embeddings), ``mamba`` (``models.ssm``), ``mlstm`` and ``slstm``
(``models.xlstm``), and zamba2's ``shared_attn``. Only attention kinds
carry an FFN (a SwiGLU or, in an MoE config, the experts of
``models.moe``), and only where ``d_ff > 0`` or the config has experts,
so xlstm's d_ff 0 is legal.

A ``shared_attn`` layer holds no weights of its own: its dict in
``params["layers"]`` is empty, and it runs the block of
``params["shared_attn"][s]`` (norm1, attn, norm2, mlp), one dict per set,
where s is its group's index modulo ``num_shared_attn_sets`` (the
remainder's: the group count n; the reference's ``_select_shared``). The
reference's init also draws a block at every shared position of every
group that its forward never reads; the port allocates none of them
(ROADMAP §3 item 10). Each application keeps its own KV cache.

Caches, one dict per layer: attention {"k", "v", "pos"} (and int8
scales), Mamba {"state", "conv"}, mLSTM {"state"}, sLSTM {"c", "n", "h",
"m"}. Attention decode writes into its cache in place; a recurrent
layer's decode returns a new dict of new tensors.

A multi-codebook model (``num_codebooks`` K > 1, MusicGen) takes (B, K, S)
ids, sums the K embeddings of a position (a (K, V, d) table), and gives
(..., K, V) logits from a (K, d, V) head.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN, LOCAL_ATTN, MAMBA, MLSTM, SHARED_ATTN, SLSTM
from . import attention as attn_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (dense_param, embed_tokens, lm_head_logits, rms_norm,
                     swiglu, trunc_normal)
from .moe import init_moe, moe_ffn
from ..sharding import context as shctx


_ATTN_KINDS = (ATTN, LOCAL_ATTN, SHARED_ATTN)
_KINDS = _ATTN_KINDS + (MAMBA, MLSTM, SLSTM)


def check_config(cfg):
    """Raise ``ValueError`` for a layer kind of ``cfg`` that the port does
    not know."""
    g, _, rem = cfg.pattern_blocks()
    for kind in tuple(g) + tuple(rem):
        if kind not in _KINDS:
            raise ValueError(f"{cfg.name}: the '{kind}' layer kind is not "
                             "ported")


def _has_ffn(cfg, kind):
    """Only attention kinds carry an FFN (the reference's ``_has_ffn``)."""
    return kind in _ATTN_KINDS and (cfg.d_ff > 0 or cfg.is_moe)


def layer_kinds(cfg):
    """The kind of every layer in order: the pattern r-major, then the
    remainder."""
    g, n, rem = cfg.pattern_blocks()
    return tuple(g) * n + tuple(rem)


def shared_set(cfg, i):
    """The weight set a ``shared_attn`` layer i runs: its group's index
    modulo ``num_shared_attn_sets``; the remainder's group index is n."""
    g, n, _ = cfg.pattern_blocks()
    return min(i // len(g), n) % cfg.num_shared_attn_sets


def layer_params(params, cfg):
    """The parameter dict every layer runs, in order: its own, or for a
    ``shared_attn`` layer its shared set's."""
    return [params["shared_attn"][shared_set(cfg, i)] if kind == SHARED_ATTN
            else lp for i, (kind, lp) in enumerate(zip(layer_kinds(cfg),
                                                       params["layers"]))]


def _block_window(cfg, kind, long_context):
    """The attention window of a layer of ``kind``, or None (the
    reference's ``_block_window``)."""
    if kind == LOCAL_ATTN:
        return cfg.sliding_window
    if long_context:           # dense fallback: windowed global attention
        return cfg.long_context_window
    return None


def layer_windows(cfg, long_context=False):
    """``_block_window`` of every layer in order (a recurrent layer's is
    not read)."""
    return [_block_window(cfg, kind, long_context) for kind in layer_kinds(cfg)]


def init_params(gen, cfg, device, dtype=None):
    """Seeded random parameters drawn from ``gen`` on ``device``: matmul
    weights and expert banks in ``dtype`` (default: the compute dtype, for
    serving; training passes ``cfg.param_dtype``), norm weights in float32
    (zeros), an MoE router and the recurrent blocks' gates, convs and
    biases in float32. Shared attention sets go to
    ``params["shared_attn"]``; their layers' own dicts are empty. A
    multi-codebook config gets a (K, V, d) embedding and a (K, d, V) head.
    On the meta device every leaf has its shape and dtype and nothing is
    drawn (``gen`` may be None)."""
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

    K, V = cfg.num_codebooks, cfg.vocab_size
    book = (K,) if K > 1 else ()
    params = {"embed": trunc_normal(gen, book + (V, d), 1.0, wdt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = trunc_normal(gen, book + (d, V), 1.0 / math.sqrt(d),
                                         wdt, device)
    params["final_norm"] = norm()

    def block(kind):
        lp = {"norm1": norm()}
        if kind in _ATTN_KINDS:
            lp["attn"] = attn()
        elif kind == MAMBA:
            lp["mamba"] = ssm_mod.init_mamba(gen, cfg, wdt, device)
        elif kind == MLSTM:
            lp["mlstm"] = xlstm_mod.init_mlstm(gen, cfg, wdt, device)
        else:
            lp["slstm"] = xlstm_mod.init_slstm(gen, cfg, wdt, device)
        if _has_ffn(cfg, kind):
            lp["norm2"] = norm()
            if cfg.is_moe:
                lp["moe"] = init_moe(gen, cfg, wdt, device)
            else:
                lp["mlp"] = {"w_gate": dense(d, f), "w_up": dense(d, f),
                             "w_down": dense(f, d)}
        return lp

    kinds = layer_kinds(cfg)
    params["layers"] = [{} if kind == SHARED_ATTN else block(kind)
                        for kind in kinds]
    if SHARED_ATTN in kinds:
        params["shared_attn"] = [block(SHARED_ATTN)
                                 for _ in range(cfg.num_shared_attn_sets)]
    return params


def init_cache(cfg, batch, max_len, device, long_context=False,
               kv_quant=False):
    """One empty cache dict per layer. An attention layer's KV cache
    (positions -1 = empty slot) has ``min(max_len, window)`` slots in a
    windowed layer (a ring) and ``max_len`` in the others; ``kv_quant``
    builds the int8 layout (``quant.kvcache``): int8 k/v plus fp32
    per-(slot, head) "k_scale"/"v_scale" of shape (B, S, Hkv). A recurrent
    layer's holds its zero state."""
    check_config(cfg)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    caches = []
    for kind, window in zip(layer_kinds(cfg),
                            layer_windows(cfg, long_context)):
        if kind == MAMBA:
            caches.append(ssm_mod.init_mamba_cache(cfg, batch,
                                                   cfg.compute_dtype, device))
            continue
        if kind == MLSTM:
            caches.append(xlstm_mod.init_mlstm_cache(cfg, batch, device))
            continue
        if kind == SLSTM:
            caches.append(xlstm_mod.init_slstm_cache(cfg, batch, device))
            continue
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
    window only masks. A recurrent layer's state is O(1) a row and has
    nothing to page: such a pattern is refused with the reference's
    ``ValueError``.

    The pool is zeroed, not left uninitialised: every row's gathered view
    holds null-page and never-written slots at probability 0, and a
    non-finite value there would turn 0 * V into NaN."""
    check_config(cfg)
    g, _, rem = cfg.pattern_blocks()
    for kind in tuple(g) + tuple(rem):
        if kind not in _ATTN_KINDS:
            raise ValueError("paged KV cache requires an attention-only "
                             f"pattern; got {kind}")
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
    x = _maybe_seq_shard_ffn(x)        # the reference's context-parallel FFN
    return swiglu(lp["mlp"], x), None


def _maybe_seq_shard_ffn(h):
    """Optimized profile, long sequences (the reference's §Perf it.3):
    shard the FFN input on its sequence over the model axis, so the FFN
    runs (B, S/16, d) against the TP weights and exchanges (B, S/16, d)
    activations instead of the replicated sequence's. A no-op without a
    mesh, in the baseline profile, below 4096 positions, where the model
    axis does not divide them, and on a plain tensor."""
    mesh = shctx.get_mesh()
    if mesh is None or not shctx.optimized():
        return h
    sizes = shctx.mesh_sizes(mesh)
    maxis = shctx.model_axis()
    S = h.shape[1]
    if S < 4096 or S % sizes[maxis] != 0:
        return h
    daxes = shctx.data_axes()
    nB = 1
    for a in daxes:
        nB *= sizes[a]
    b = daxes if h.shape[0] % nB == 0 else ()
    return shctx.maybe_constraint(h, b, maxis, None)


def _mixer(lp, kind, h, cfg, mode, positions, cache, window, cache_len,
           slots, attn_mask, page_table):
    """The layer's attention or recurrent block on its normed input:
    (y, its cache after the call; None in training)."""
    if kind in _ATTN_KINDS:
        if mode == "train":
            return attn_mod.causal_attention(lp["attn"], h, positions, cfg,
                                             window), None
        if mode == "prefill":
            return attn_mod.prefill_attention(lp["attn"], h, positions, cfg,
                                              cache_len, window)
        if page_table is not None:
            return attn_mod.paged_decode_attention(
                lp["attn"], h, cache, page_table, positions, cfg, window,
                slots=slots, attn_mask=attn_mask)
        return attn_mod.decode_attention(lp["attn"], h, cache, positions, cfg,
                                         window, slots=slots,
                                         attn_mask=attn_mask)
    if kind == MAMBA:
        if mode == "decode":
            y, (st, conv) = ssm_mod.mamba_decode(lp["mamba"], h, cfg,
                                                 cache["state"], cache["conv"])
        else:
            y, (st, conv) = ssm_mod.mamba_forward(lp["mamba"], h, cfg)
        return y, {"state": st, "conv": conv}
    if kind == MLSTM:
        if mode == "decode":
            y, st = xlstm_mod.mlstm_decode(lp["mlstm"], h, cfg, cache["state"])
        else:
            y, st = xlstm_mod.mlstm_forward(lp["mlstm"], h, cfg)
        return y, {"state": st}
    return xlstm_mod.slstm_forward(lp["slstm"], h, cfg,
                                   cache if mode == "decode" else None)


def apply_block(lp, kind, x, cfg, mode, positions, cache=None, window=None,
                cache_len=0, slots=None, attn_mask=None, page_table=None,
                with_aux=False):
    """One pre-norm layer: (x after it, its cache (None in training), the
    MoE aux with ``with_aux`` or None)."""
    x = shctx.batch_constraint(x)     # a sharded step's residual stream
    y, c = _mixer(lp, kind, rms_norm(x, lp["norm1"], cfg.norm_eps), cfg,
                  mode, positions, cache, window, cache_len, slots, attn_mask,
                  page_table)
    x = x + y
    aux = None
    if _has_ffn(cfg, kind):
        y, aux = _ffn(lp, rms_norm(x, lp["norm2"], cfg.norm_eps), cfg,
                      with_aux)
        x = x + y
    return x, (None if mode == "train" else c), aux


def backbone(params, tokens, cfg, mode, positions=None, cache=None,
             long_context=False, cache_len=0, slots=None, attn_mask=None,
             page_table=None, with_aux=False):
    """tokens: (B, S) int, or (B, K, S) for a multi-codebook model.
    ``mode`` is "train" (no caches), "prefill" (builds caches of
    ``cache_len`` slots in every attention layer, and a recurrent layer's
    state after the prompt from a zero state, as the reference does) or
    "decode" (writes into ``cache``; with ``page_table`` (B, max_pages)
    the cache is the shared paged pool of ``init_paged_cache``). Every
    mode attends within each layer's ``_block_window``; ``long_context``
    windows the global layers too.
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
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} is not ported")
    x = embed_tokens(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    layers = zip(layer_kinds(cfg), layer_params(params, cfg),
                 layer_windows(cfg, long_context))
    if mode == "train":
        remat = cfg.remat and torch.is_grad_enabled()
        aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                     if with_aux else None)
        for kind, lp, window in layers:
            if remat:
                x, _, aux = checkpoint(apply_block, lp, kind, x, cfg, mode,
                                       positions, None, window,
                                       with_aux=with_aux, use_reentrant=False)
            else:
                x, _, aux = apply_block(lp, kind, x, cfg, mode, positions,
                                        window=window, with_aux=with_aux)
            if aux is not None:
                aux_total = aux_total + aux
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total
    caches = []
    for i, (kind, lp, window) in enumerate(layers):
        x, c, _ = apply_block(lp, kind, x, cfg, mode, positions,
                              cache[i] if mode == "decode" else None, window,
                              cache_len, slots, attn_mask, page_table)
        caches.append(c)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def logits_from_hidden(params, hidden, cfg):
    w = (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
         else params["lm_head"])
    return lm_head_logits(w, hidden, cfg.final_softcap)

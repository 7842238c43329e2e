"""GQA attention: training and prefill (query-chunked causal) and decode
against a KV cache, with the slots and ancestor masks of tree speculation
(``repro.models.attention``): the dense per-row cache and the shared paged
pool of continuous serving (``paged_decode_attention``).

Dispatch is the reference's: a tree-masked decode call goes to the tree
attention kernel (``kernels.ops.tree_verify_attention``); training, prefill and
every other decode call run the plain masked ``_sdpa``, as the reference runs
them outside any Pallas kernel. Unlike the reference's ``S % 128`` rule,
the kernel takes any cache width, so no tree call falls back to ``_sdpa``.

Caches are dicts {"k", "v": (B, Smax, Hkv, hd), "pos": (B, Smax)}, and in
the int8 layout (``quant.kvcache``) also {"k_scale", "v_scale": (B, Smax,
Hkv)}. Where the reference returns a new cache from ``.at[].set``, the port
writes the new entries into the cache tensors in place (``index_put_``) and
returns the same dict.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from ..quant.kvcache import (dequantize_kv_entry, kv_quantized,
                             quantize_kv_entry)
from .layers import apply_rope, matmul_param, softcap

NEG_INF = -2.0e38


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = matmul_param(x, params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = matmul_param(x, params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = matmul_param(x, params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd), mask: (Sq, Skv) or
    (B, Sq, Skv). fp32 scores, probabilities cast back to q's dtype."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _tree_attend(q, k, v, mask, cfg):
    """q (B, T, H, hd), k/v (B, S, Hkv, hd), mask (B, T, S) -> (B, T, H, hd):
    all T tree nodes in one kernel launch."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd).transpose(1, 2).contiguous()
    out = ops.tree_verify_attention(qg, k, v, mask.contiguous(),
                                    softcap=cfg.attn_softcap)
    return out.transpose(1, 2).reshape(B, T, H, hd).to(q.dtype)


def _attend(q, k, v, mask, cfg, tree: bool):
    if tree:
        return _tree_attend(q, k, v, mask, cfg)
    return _sdpa(q, k, v, mask, cfg)


def _causal(params, x, positions, cfg):
    """Causal self-attention of x, looped over query chunks of
    ``cfg.attn_chunk`` (one chunk where the length is no multiple of it).
    Returns (out after the output projection, k, v, kv positions (B, S))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    kv_pos = positions if positions.dim() == 2 else positions[None].expand(B, S)
    C = min(cfg.attn_chunk, S)
    if S % C != 0:
        C = S
    outs = []
    for i in range(0, S, C):
        m = kv_pos[:, i:i + C, None] >= kv_pos[:, None, :]
        outs.append(_sdpa(q[:, i:i + C], k, v, m, cfg))
    out = torch.cat(outs, dim=1).reshape(B, S, cfg.num_heads * cfg.head_dim_)
    return matmul_param(out, params["wo"]), k, v, kv_pos


def causal_attention(params, x, positions, cfg):
    """Full-sequence causal attention of training: no cache."""
    return _causal(params, x, positions, cfg)[0]


def prefill_attention(params, x, positions, cfg, cache_len: int):
    """Causal attention over the prompt; returns (out, cache of
    ``cache_len`` slots in the ring layout of ``decode_attention``)."""
    B, S, _ = x.shape
    out, k, v, kv_pos = _causal(params, x, positions, cfg)

    dt = cfg.compute_dtype
    shape = (B, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    kc = torch.zeros(shape, dtype=dt, device=x.device)
    vc = torch.zeros(shape, dtype=dt, device=x.device)
    cp = torch.full((B, cache_len), -1, dtype=torch.int32, device=x.device)
    if S <= cache_len:
        kc[:, :S] = k
        vc[:, :S] = v
        cp[:, :S] = kv_pos
    else:   # ring layout: the last cache_len positions, at slot pos % cache_len
        keep = S - cache_len
        slots = (kv_pos[:, keep:] % cache_len).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        kc[bidx, slots] = k[:, keep:].to(dt)
        vc[bidx, slots] = v[:, keep:].to(dt)
        cp[bidx, slots] = kv_pos[:, keep:].to(torch.int32)
    return out, {"k": kc, "v": vc, "pos": cp}


def decode_attention(params, x, cache, pos, cfg, slots=None, attn_mask=None):
    """Decode T new tokens against a (ring-indexed) KV cache.

    x: (B, T, D) new tokens (T = 1, gamma+1 in chain verify, or the tree
      nodes of one level or of the whole tree).
    pos: (B, T) RoPE positions of x.
    slots: optional (B, T) storage positions overriding ``pos`` for cache
      insertion (tree siblings share a position, never a slot); "pos" then
      records the storage position.
    attn_mask: optional (B, T, Smax) slot-aligned mask replacing positional
      causality (tree ancestor masks); validity of written slots is still
      enforced here. Such calls go through the tree attention kernel.
    An int8 cache (one with "k_scale") gets the new entries quantized per
    (slot, kv head) on write, and attention reads its dequantized view.
    Returns (out, cache) with the new tokens written into ``cache``.
    """
    B, T, _ = x.shape
    kcache, vcache, cache_pos = cache["k"], cache["v"], cache["pos"]
    Smax = kcache.shape[1]
    q, k, v = _project_qkv(params, x, cfg, pos)
    write_pos = pos if slots is None else slots
    slot_idx = (write_pos % Smax).long()
    bidx = torch.arange(B, device=x.device)[:, None]
    if kv_quantized(cache):
        kq, ks = quantize_kv_entry(k)
        vq, vs = quantize_kv_entry(v)
        kcache[bidx, slot_idx] = kq
        vcache[bidx, slot_idx] = vq
        cache["k_scale"][bidx, slot_idx] = ks
        cache["v_scale"][bidx, slot_idx] = vs
        kc = dequantize_kv_entry(kcache, cache["k_scale"], q.dtype)
        vc = dequantize_kv_entry(vcache, cache["v_scale"], q.dtype)
    else:
        kcache[bidx, slot_idx] = k.to(kcache.dtype)
        vcache[bidx, slot_idx] = v.to(vcache.dtype)
        kc, vc = kcache.to(q.dtype), vcache.to(q.dtype)
    cache_pos[bidx, slot_idx] = write_pos.to(torch.int32)
    if attn_mask is None:
        m = (cache_pos[:, None, :] >= 0) & (cache_pos[:, None, :] <= pos[:, :, None])
    else:
        m = (cache_pos[:, None, :] >= 0) & attn_mask
    out = _attend(q, kc, vc, m, cfg, tree=attn_mask is not None)
    out = matmul_param(out.reshape(B, T, cfg.num_heads * cfg.head_dim_),
                       params["wo"])
    return out, cache


def _zero_null_page(pool):
    """Page 0 is the null page: writes routed there (rows masked out of a
    round, unallocated table entries) are dropped by zeroing it again, so
    the gathered views read zeros, never non-finite values, in its slots.
    Those slots are masked, and 0 * NaN would still poison p @ V."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in pool:
            pool[name][0].zero_()


def paged_decode_attention(params, x, cache, page_table, pos, cfg,
                           slots=None, attn_mask=None):
    """Decode T new tokens against a shared paged KV pool.

    cache: {"k", "v": (P, page, Hkv, hd), "page_pos": (P, page)} (int8
      pools add "k_scale", "v_scale": (P, page, Hkv)): one physical pool
      shared by every row; "page_pos" holds the absolute position written
      into each pool slot (-1 = empty).
    page_table: (B, max_pages) int mapping a row's logical page (position
      // page) to a physical page. Physical page 0 is the null page:
      unallocated entries point there, masked-out rows write there, and
      reads through a 0 entry are masked; it is zeroed after every write
      (``_zero_null_page``), where the reference keeps what was written.
    pos: (B, T) absolute RoPE positions of x.
    slots: optional (B, T) storage positions overriding ``pos`` for the pool
      scatter (tree siblings share a position, never a slot).
    attn_mask: optional (B, T, max_pages * page) mask over the gathered view
      replacing positional causality; such calls go through the tree
      attention kernel, at a width that is any multiple of the page size.

    Shared (prefix-cache) pages appear in several rows' tables; they are
    read-only by the allocator's contract, so every write here lands on a
    page private to its row (serving.kv_pool). Returns (out, cache) with
    the new tokens written into the pool in place.
    """
    B, T, _ = x.shape
    kpool, vpool, page_pos = cache["k"], cache["v"], cache["page_pos"]
    page = page_pos.shape[1]
    table = page_table.long()
    max_pages = table.shape[1]
    W = max_pages * page
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    q, k, v = _project_qkv(params, x, cfg, pos)
    write_pos = (pos if slots is None else slots).long()
    phys = table.gather(1, (write_pos // page).clamp(0, max_pages - 1))
    off = write_pos % page
    if kv_quantized(cache):
        kq, ks = quantize_kv_entry(k)
        vq, vs = quantize_kv_entry(v)
        kpool[phys, off] = kq
        vpool[phys, off] = vq
        cache["k_scale"][phys, off] = ks
        cache["v_scale"][phys, off] = vs
        _zero_null_page(cache)
        kc = dequantize_kv_entry(kpool[table], cache["k_scale"][table], q.dtype)
        vc = dequantize_kv_entry(vpool[table], cache["v_scale"][table], q.dtype)
    else:
        kpool[phys, off] = k.to(kpool.dtype)
        vpool[phys, off] = v.to(vpool.dtype)
        _zero_null_page(cache)
        kc, vc = kpool[table].to(q.dtype), vpool[table].to(q.dtype)
    kc, vc = kc.reshape(B, W, Hkv, hd), vc.reshape(B, W, Hkv, hd)
    page_pos[phys, off] = write_pos.to(torch.int32)
    cp = torch.where((table == 0)[:, :, None], -1, page_pos[table]).reshape(B, W)
    if attn_mask is None:
        m = (cp[:, None, :] >= 0) & (cp[:, None, :] <= pos[:, :, None])
    else:
        m = (cp[:, None, :] >= 0) & attn_mask
    out = _attend(q, kc, vc, m, cfg, tree=attn_mask is not None)
    out = matmul_param(out.reshape(B, T, cfg.num_heads * cfg.head_dim_),
                       params["wo"])
    return out, cache

"""GQA attention: prefill (query-chunked causal) and decode against a KV
cache, with the slots and ancestor masks of tree speculation
(``repro.models.attention``, dense unpaged path).

Dispatch is the reference's: a tree-masked decode call goes to the tree
attention kernel (``kernels.ops.tree_verify_attention``); prefill and every
other decode call run the plain masked ``_sdpa``, as the reference runs
them outside any Pallas kernel. Unlike the reference's ``S % 128`` rule,
the kernel takes any cache width, so no tree call falls back to ``_sdpa``.

Caches are dicts {"k", "v": (B, Smax, Hkv, hd), "pos": (B, Smax)}. Where
the reference returns a new cache from ``.at[].set``, the port writes the
new entries into the cache tensors in place (``index_put_``) and returns
the same dict.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
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


def prefill_attention(params, x, positions, cfg, cache_len: int):
    """Causal attention over the prompt, scanned over query chunks of
    ``cfg.attn_chunk``; returns (out, cache of ``cache_len`` slots in the
    ring layout of ``decode_attention``)."""
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
    out = matmul_param(out, params["wo"])

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
    Returns (out, cache) with the new tokens written into ``cache``.
    """
    B, T, _ = x.shape
    kcache, vcache, cache_pos = cache["k"], cache["v"], cache["pos"]
    Smax = kcache.shape[1]
    q, k, v = _project_qkv(params, x, cfg, pos)
    write_pos = pos if slots is None else slots
    slot_idx = (write_pos % Smax).long()
    bidx = torch.arange(B, device=x.device)[:, None]
    kcache[bidx, slot_idx] = k.to(kcache.dtype)
    vcache[bidx, slot_idx] = v.to(vcache.dtype)
    cache_pos[bidx, slot_idx] = write_pos.to(torch.int32)
    kc, vc = kcache.to(q.dtype), vcache.to(q.dtype)
    if attn_mask is None:
        m = (cache_pos[:, None, :] >= 0) & (cache_pos[:, None, :] <= pos[:, :, None])
    else:
        m = (cache_pos[:, None, :] >= 0) & attn_mask
    out = _attend(q, kc, vc, m, cfg, tree=attn_mask is not None)
    out = matmul_param(out.reshape(B, T, cfg.num_heads * cfg.head_dim_),
                       params["wo"])
    return out, cache

"""GQA attention, with optional qk-norm and a sliding window: training and
prefill (query-chunked causal) and decode against a KV cache, with the
slots and ancestor masks of tree speculation (``repro.models.attention``):
the dense per-row cache and the shared paged pool of continuous serving
(``paged_decode_attention``).

``window`` (Gemma-2's local layers, or every layer in long-context mode)
keeps a key only where its position is above the query's position minus
the window; it is ANDed into the mask before attention, so a tree-masked
call reaches the tree attention kernel with the window folded in.

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
from ..sharding import context as shctx
from .layers import apply_rope, matmul_param, rms_norm, softcap

NEG_INF = -2.0e38


def _prod(sizes, axes):
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _opt_seq_shard(q, k, v, cfg):
    """Optimized-profile fix (the reference's §Perf it.1, phi4-class
    archs): where num_heads does not divide the model axis, constrain K/V
    to be sequence-sharded over it (q whole on the sequence), so that
    scores are computed per KV shard instead of all-reducing the full
    score tensor per query chunk."""
    mesh = shctx.get_mesh()
    if mesh is None or not shctx.optimized():
        return q, k, v
    sizes = shctx.mesh_sizes(mesh)
    maxis = shctx.model_axis()
    msize = sizes[maxis]
    if cfg.num_heads % msize == 0 or k.shape[1] % msize != 0:
        return q, k, v                       # head sharding works / S odd
    daxes = shctx.data_axes()
    b = daxes if q.shape[0] % _prod(sizes, daxes) == 0 else ()
    q = shctx.maybe_constraint(q, b, None, None, None)
    k = shctx.maybe_constraint(k, b, maxis, None, None)
    v = shctx.maybe_constraint(v, b, maxis, None, None)
    return q, k, v


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = shctx.tp_layout(matmul_param(x, params["wq"]), H)
    k = shctx.tp_layout(matmul_param(x, params["wk"]), Hkv)
    v = shctx.tp_layout(matmul_param(x, params["wv"]), Hkv)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if S > 1:   # not the decode path: pin layouts before RoPE (the
        # reference's SPerf it.2: constraining after RoPE forced copies)
        q, k, v = _opt_seq_shard(q, k, v, cfg)
    if cfg.qk_norm:     # per head, in float32, cast back before RoPE
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd), mask: (Sq, Skv) or
    (B, Sq, Skv). fp32 scores, probabilities cast back to q's dtype. A
    sharded step (DTensors) runs it in a region of local shards, since
    DTensor's rule for the ``bmm`` of its einsums cannot take heads or a
    sequence split over the model axis once they are flattened with the
    batch: K/V whose sequence the model axis splits (a sharded cache, the
    optimized profile's ``_opt_seq_shard``) attend per key shard with the
    softmax's max and sum and the output reduced over the model axis
    (``_sdpa_seq_sharded``); others on each rank's batch shard with every
    head (``batch_local``)."""
    def local(q, k, v, mask):
        return _sdpa_local(q, k, v, mask, cfg)
    if _seq_sharded(k):
        return _sdpa_seq_sharded(q, k, v, mask, cfg)
    if mask.dim() == 2:
        return shctx.batch_local(local, (q, k, v), (mask,))
    return shctx.batch_local(local, (q, k, v, mask))


def _seq_sharded(k) -> bool:
    """Whether DTensor ``k`` (B, S, Hkv, hd) has its sequence split over
    the model axis."""
    if not shctx.is_dtensor(k):
        return False
    from torch.distributed.tensor import Shard
    i = list(shctx.mesh_sizes(shctx.get_mesh())).index(shctx.model_axis())
    return k.placements[i] == Shard(1)


def _sdpa_seq_sharded(q, k, v, mask, cfg):
    """``_sdpa`` of DTensors whose K/V sequence the model axis splits, as
    the reference's GSPMD partitions it: each model rank scores every
    head of its batch shard's queries against its keys, the softmax's max
    and sum are reduced over the model axis ((B, H, Sq) statistics), and
    so are the normalized outputs, which then come back whole over the
    model axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, maxis = shctx.get_mesh(), shctx.model_axis()
    sizes = shctx.mesh_sizes(mesh)
    daxes = shctx.data_axes()
    b = daxes if q.shape[0] % _prod(sizes, daxes) == 0 else None
    qd = shctx.maybe_constraint(q, b)
    place = qd.placements
    # every model rank reads all of q: its gradient is a partial sum there
    qgrad = [Partial() if a == maxis else p for a, p in zip(sizes, place)]
    ql = qd.to_local(grad_placements=qgrad)
    kl = shctx.maybe_constraint(k, b, maxis).to_local()
    vl = shctx.maybe_constraint(v, b, maxis).to_local()
    if not shctx.is_dtensor(mask):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    ml = (shctx.maybe_constraint(mask, None, maxis) if mask.dim() == 2 else
          shctx.maybe_constraint(mask, b, None, maxis)).to_local()
    B, Sq, H, hd = ql.shape
    Hkv = kl.shape[2]
    qg = ql.reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kl).float() / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    ml = ml[None] if ml.dim() == 2 else ml
    s = torch.where(ml[:, None, None], s, NEG_INF)
    # the shift cancels in the softmax: no gradient through the max
    top = shctx.all_reduce(s.detach().amax(-1, keepdim=True), "max", mesh,
                           (maxis,))
    p = torch.exp(s - top)
    p = p / shctx.all_reduce(p.sum(-1, keepdim=True), "sum", mesh, (maxis,))
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(ql.dtype), vl)
    out = shctx.all_reduce(out, "sum", mesh, (maxis,)).reshape(B, Sq, H, hd)
    return DTensor.from_local(out, mesh, place, run_check=False)


def _sdpa_local(q, k, v, mask, cfg):
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


def _causal(params, x, positions, cfg, window=None):
    """Causal self-attention of x, looped over query chunks of
    ``cfg.attn_chunk`` (one chunk where the length is no multiple of it),
    within ``window`` positions where one is given. Returns (out after the
    output projection, k, v, kv positions (B, S))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    # a sharded step gathers the heads once, not in every chunk's _sdpa
    # (K/V whose sequence the optimized profile splits stay split)
    q = shctx.batch_constraint(q)
    if not _seq_sharded(k):
        k, v = shctx.batch_constraint(k), shctx.batch_constraint(v)
    kv_pos = positions if positions.dim() == 2 else positions[None].expand(B, S)
    C = min(cfg.attn_chunk, S)
    if S % C != 0:
        C = S
    outs = []
    for i in range(0, S, C):
        qp = kv_pos[:, i:i + C, None]
        m = qp >= kv_pos[:, None, :]
        if window is not None:
            m &= kv_pos[:, None, :] > qp - window
        outs.append(_sdpa(q[:, i:i + C], k, v, m, cfg))
    out = torch.cat(outs, dim=1).reshape(B, S, cfg.num_heads * cfg.head_dim_)
    # a sharded step: the gradient must come back in a layout that splits
    # into the heads
    out = shctx.tp_layout(out, cfg.num_heads)
    return matmul_param(out, params["wo"]), k, v, kv_pos


def causal_attention(params, x, positions, cfg, window=None):
    """Full-sequence causal attention of training: no cache."""
    return _causal(params, x, positions, cfg, window)[0]


def prefill_attention(params, x, positions, cfg, cache_len: int,
                      window=None):
    """Causal attention over the prompt; returns (out, cache of
    ``cache_len`` slots in the ring layout of ``decode_attention``)."""
    B, S, _ = x.shape
    out, k, v, kv_pos = _causal(params, x, positions, cfg, window)

    dt = cfg.compute_dtype
    shape = (B, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    kc = k.new_zeros(shape, dtype=dt)     # a DTensor k makes a DTensor
    vc = v.new_zeros(shape, dtype=dt)
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


def decode_attention(params, x, cache, pos, cfg, window=None, slots=None,
                     attn_mask=None):
    """Decode T new tokens against a (ring-indexed) KV cache.

    x: (B, T, D) new tokens (T = 1, gamma+1 in chain verify, or the tree
      nodes of one level or of the whole tree).
    pos: (B, T) RoPE positions of x.
    slots: optional (B, T) storage positions overriding ``pos`` for cache
      insertion (tree siblings share a position, never a slot); "pos" then
      records the storage position.
    attn_mask: optional (B, T, Smax) slot-aligned mask replacing positional
      causality (tree ancestor masks); validity of written slots is still
      enforced here, and so is ``window``. Such calls go through the tree
      attention kernel.
    All T entries are written before any is attended, as in the reference:
    in a ring narrower than the positions it holds (a window-sized cache)
    a call with T > 1 overwrites the oldest in-window keys of its own
    earlier queries.
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

    def put(t, val):
        if shctx.is_dtensor(t):     # a sharded cache: the dry run's trace
            _write_sharded(t, slot_idx, val)
        else:
            t[bidx, slot_idx] = val

    if kv_quantized(cache):
        kq, ks = quantize_kv_entry(k)
        vq, vs = quantize_kv_entry(v)
        put(kcache, kq)
        put(vcache, vq)
        put(cache["k_scale"], ks)
        put(cache["v_scale"], vs)
        kc = dequantize_kv_entry(kcache, cache["k_scale"], q.dtype)
        vc = dequantize_kv_entry(vcache, cache["v_scale"], q.dtype)
    else:
        put(kcache, k.to(kcache.dtype))
        put(vcache, v.to(vcache.dtype))
        kc, vc = kcache.to(q.dtype), vcache.to(q.dtype)
    put(cache_pos, write_pos.to(torch.int32))
    if attn_mask is None:
        m = (cache_pos[:, None, :] >= 0) & (cache_pos[:, None, :] <= pos[:, :, None])
    else:
        m = (cache_pos[:, None, :] >= 0) & attn_mask
    if window is not None:
        m &= cache_pos[:, None, :] > pos[:, :, None] - window
    out = _attend(q, kc, vc, m, cfg, tree=attn_mask is not None)
    out = shctx.tp_layout(out.reshape(B, T, cfg.num_heads * cfg.head_dim_),
                          cfg.num_heads)
    return matmul_param(out, params["wo"]), cache


def _write_sharded(cache_t, slot_idx, val):
    """``cache_t[arange(B)[:, None], slot_idx] = val`` in place for a
    DTensor cache whose batch and slot dims may be sharded (the dry run's
    layout, ``launch.specs.cache_shardings``), as XLA partitions a scatter
    into a sharded operand: each rank writes the entries whose slots it
    holds, at its local offsets, with no collective. ``val`` (B, T, ...)
    and ``slot_idx`` (B, T) are first laid out as the cache on its batch
    and trailing dims. An entry another rank holds rewrites the row's
    first entry this rank holds (or the row's slot 0 with its own value),
    so duplicate indices carry equal values and the write is order-free."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache_t.device_mesh

    def local(t):
        want = [p if isinstance(p, Shard) and p.dim != 1 and p.dim < t.dim()
                else Replicate() for p in cache_t.placements]
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want).to_local()

    dst = cache_t.to_local()
    n_loc = dst.shape[1]
    coord, block = mesh.get_coordinate(), 0
    for i, p in enumerate(cache_t.placements):
        if p == Shard(1):
            block = block * mesh.size(i) + coord[i]
    idx = local(slot_idx) - block * n_loc
    v = local(val)
    own = (idx >= 0) & (idx < n_loc)
    first = own.int().argmax(1, keepdim=True)
    has = own.any(1, keepdim=True)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    idx = torch.where(own, idx, torch.where(has, idx.gather(1, first), 0))
    tail = (1,) * (v.dim() - 2)
    own_v, has_v = own.reshape(own.shape + tail), has.reshape(has.shape + tail)
    v = torch.where(own_v, v, torch.where(has_v, v[rows, first], dst[rows, :1]))
    dst[rows, idx] = v


def _zero_null_page(pool):
    """Page 0 is the null page: writes routed there (rows masked out of a
    round, unallocated table entries) are dropped by zeroing it again, so
    the gathered views read zeros, never non-finite values, in its slots.
    Those slots are masked, and 0 * NaN would still poison p @ V."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in pool:
            pool[name][0].zero_()


def paged_decode_attention(params, x, cache, page_table, pos, cfg,
                           window=None, slots=None, attn_mask=None):
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
    window: pages keep every position; the window only masks.

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
    if window is not None:
        m &= cp[:, None, :] > pos[:, :, None] - window
    out = _attend(q, kc, vc, m, cfg, tree=attn_mask is not None)
    out = matmul_param(out.reshape(B, T, cfg.num_heads * cfg.head_dim_),
                       params["wo"])
    return out, cache

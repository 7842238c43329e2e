"""int8 KV cache (``repro.quant.kvcache``, dense ring cache).

Beside the int8 ``"k"``/``"v"`` tensors a quantized layer cache holds fp32
per-slot-per-head scales ``"k_scale"``/``"v_scale"`` of shape (B, S, Hkv):
one absmax scale per cache slot and kv head, so that a write is a pure
scatter and an entry's scale depends on that entry alone. The attention
layers dispatch on structure (a cache with ``"k_scale"`` is quantized), so
no model call signature changes; ``init_cache(kv_quant=True)`` builds the
layout and ``quantize_kv_cache`` converts a full-precision cache, such as
one straight out of prefill. ``"pos"`` is untouched, so every rewind and
trim keeps working by position alone.
"""
from __future__ import annotations

import torch

KV_EPS = 1e-8


def kv_quantized(cache) -> bool:
    """True iff this layer cache dict uses the int8 layout."""
    return isinstance(cache, dict) and "k_scale" in cache


def quantize_kv_entry(k):
    """(..., hd) float -> (int8 values, fp32 per-(slot, head) scale (...,))."""
    kf = k.float()
    scale = kf.abs().amax(dim=-1).clamp(min=KV_EPS) / 127.0
    q = torch.round(kf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_entry(q, scale, dtype):
    """int8 values + scales -> (..., hd) in ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def quantize_kv_cache(cache):
    """The port's list of per-layer cache dicts in the int8 layout (new
    dicts; layers already quantized are kept as they are)."""
    out = []
    for layer in cache:
        if "k" in layer and "v" in layer and not kv_quantized(layer):
            kq, ks = quantize_kv_entry(layer["k"])
            vq, vs = quantize_kv_entry(layer["v"])
            layer = {**layer, "k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        out.append(layer)
    return out

"""Core building blocks on tensors: matmul dispatch, RMSNorm, RoPE, SwiGLU,
embeddings and the LM head (``repro.models.layers``).

Matmul weights are held in the compute dtype. The reference keeps them in
``param_dtype`` (float32) and casts each 2-D weight to the activation dtype
at every matmul, so holding the cast copy gives every matmul the same
values, and the 7B target takes 13.5 GB on the card instead of 27 GB. Norm
weights stay float32: ``rms_norm`` reads them in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def matmul_param(x, w):
    """x (..., K) @ w (K, N): the single dispatch point for every 2-D weight
    matmul in the model."""
    return x @ w.to(x.dtype)


def trunc_normal(gen, shape, scale, dtype, device):
    """``scale`` times a standard normal truncated to [-3, 3], drawn in
    float32 from ``gen`` and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * scale).to(dtype)


def dense_param(gen, in_dim, out_dim, dtype, device):
    """A (in, out) matmul weight, scaled by 1/sqrt(in_dim)."""
    return trunc_normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                        dtype, device)


def rms_norm(x, weight, eps):
    """RMSNorm in float32, scaled by ``1 + weight`` (zero-initialised)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dt)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions, head_dim, theta):
    """positions: int tensor (...,) -> (..., head_dim//2) float32 angles."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    return positions.float()[..., None] * freqs


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    ang = rope_angles(positions, x.shape[-1], theta)     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(params, x):
    g = matmul_param(x, params["w_gate"])
    u = matmul_param(x, params["w_up"])
    return matmul_param(F.silu(g) * u, params["w_down"])


def embed_tokens(table, tokens):
    """tokens: (B, S) int -> (B, S, D) rows of ``table``."""
    return table[tokens]


def lm_head_logits(w, x, cap: Optional[float] = None):
    """Final projection; logits are float32."""
    return softcap(matmul_param(x, w).float(), cap)

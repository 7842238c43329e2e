"""Quantized weight container and post-training weight quantization
(``repro.quant.qweight``).

Layouts (the contract with ``kernels.quant_matmul``):

  int8 : ``q`` (K, N) int8, ``scale`` (1, N) fp32: symmetric per-out-channel
         absmax scaling.
  int4 : ``q`` (K//2, N) uint8 with two K rows packed per byte (even row in
         the low nibble), ``scale`` (K//group, N) fp32: symmetric absmax per
         ``group`` consecutive input channels.

AWQ-lite (activation-aware) scaling: given per-input-channel activation
magnitudes ``act_amax`` from a calibration pass, each input channel k is
scaled by ``s_k = act_amax_k^alpha / w_amax_k^(1-alpha)`` (normalised to
geometric mean 1) before quantization, and ``pre = 1/s`` is stored to apply
to the activation at run time: ``x @ W == (x * pre) @ (s * W)``.

Quantization runs on the weight's own device with torch ops and gives the
same bits as the reference's numpy code on the same float32 weight: the
absmax is exact, float32 division is IEEE on both sides and ``torch.round``
rounds half to even like ``np.rint``. Only the (K,) AWQ scale vector is
computed on the host, in numpy, with the reference's own dtypes (float64,
except the weight absmax power, which numpy takes in float32).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.ref import ref_dequant


@dataclass
class QWeight:
    q: torch.Tensor                      # int8 (K, N) | uint8 packed (K//2, N)
    scale: torch.Tensor                  # fp32 (1, N) | (K//group, N)
    pre: Optional[torch.Tensor] = None   # fp32 (K,) AWQ activation pre-scale
    bits: int = 8
    group: int = 0                       # 0 = per-out-channel (int8)

    @property
    def in_dim(self) -> int:
        return self.q.shape[0] * (2 if self.bits == 4 else 1)

    @property
    def out_dim(self) -> int:
        return self.q.shape[1]

    def nbytes(self) -> int:
        """Stored bytes (quantized values + scales + pre-scale)."""
        n = self.q.numel() * self.q.element_size() + self.scale.numel() * 4
        if self.pre is not None:
            n += self.pre.numel() * 4
        return int(n)


def params_nbytes(params) -> int:
    """Stored bytes of a parameter tree: ``QWeight.nbytes`` for quantized
    leaves, element bytes for tensors."""
    if isinstance(params, QWeight):
        return params.nbytes()
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        params = params.values()
    return sum(params_nbytes(p) for p in params)


# ----------------------------------------------------------------- quantize

def _awq_scale(wmax: np.ndarray, act_amax, alpha: float) -> np.ndarray:
    """Per-input-channel AWQ scale (K,), geometric-mean normalised, from the
    weight's row absmax ``wmax`` (K,) float32: the reference's arithmetic,
    dtype for dtype."""
    a = np.maximum(np.asarray(act_amax, np.float64), 1e-8)
    wmax = np.maximum(np.asarray(wmax, np.float32), 1e-8)
    s = (a ** alpha) / (wmax ** (1.0 - alpha))
    s = s / np.exp(np.mean(np.log(s)))                    # geomean 1
    return np.clip(s, 1e-4, 1e4).astype(np.float32)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int in [-8, 7] -> (K//2, N) uint8 (even row = low nibble)."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"int4 packing needs an even K, got {K}")
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def quantize_weight(w, bits: int = 8, group: int = 64, act_amax=None,
                    awq_alpha: float = 0.5) -> QWeight:
    """Symmetric absmax PTQ of a (K, N) matmul weight, on its device.

    ``act_amax`` (K,) enables the AWQ-lite pre-scale; without it the
    quantization is plain per-channel / per-group absmax."""
    w = torch.as_tensor(w).float()
    if w.dim() != 2:
        raise ValueError(f"expected a (K, N) weight, got {tuple(w.shape)}")
    K, N = w.shape
    pre = None
    if act_amax is not None:
        wmax = w.abs().amax(dim=1).cpu().numpy()
        s = torch.from_numpy(_awq_scale(wmax, act_amax, awq_alpha)).to(w.device)
        w = w * s[:, None]
        pre = 1.0 / s
    if bits == 8:
        scale = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 127.0
        q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
        return QWeight(q=q, scale=scale, pre=pre, bits=8, group=0)
    if bits == 4:
        g = int(group)
        if g <= 0 or g % 2 or K % g:
            raise ValueError(f"int4 group {g} must be even and divide K={K}")
        wg = w.reshape(K // g, g, N)
        scale = wg.abs().amax(dim=1).clamp(min=1e-12) / 7.0      # (K//g, N)
        q = torch.round(wg / scale[:, None, :]).clamp(-8, 7).reshape(K, N)
        return QWeight(q=pack_int4(q), scale=scale, pre=pre, bits=4, group=g)
    raise ValueError(f"unsupported bits {bits}")


def dequantize(qw: QWeight) -> torch.Tensor:
    """Full-precision reconstruction (K, N) fp32, AWQ pre-scale included:
    ``x @ dequantize(qw)`` equals ``ops.dequant_matmul(x, qw)`` up to
    rounding."""
    w = ref_dequant(qw.q, qw.scale, qw.bits, qw.group)
    if qw.pre is not None:
        w = qw.pre[:, None] * w
    return w

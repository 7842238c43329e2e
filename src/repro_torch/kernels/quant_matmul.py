"""Quantized matmul on the card: the wrapper of ``csrc/quant_matmul.cu``,
the Hopper kernel that replaces the TPU kernel
``repro/kernels/quant_matmul.py`` (``quant_matmul`` -> ``_int8_kernel`` and
``_int4_kernel``).

x (M, K) @ dequant(q, scale) -> fp32 (M, N), with the weight widened in
registers: int8 q (K, N) with per-column scales (1, N), or packed int4 q
(K//2, N) with group scales (K//group, N). Any M, K and N are allowed. The
plain version is ``kernels.ref.ref_quant_matmul``;
``kernels.ops.dequant_matmul`` chooses between the two by the device of its
inputs and applies the AWQ pre-scale to x first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q_DTYPES = {8: torch.int8, 4: torch.uint8}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, q, scale, bits, group):
    if bits not in _Q_DTYPES:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"x, q and scale must be 2-D, got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    N = q.shape[1]
    if bits == 8:
        want_q, want_s = (K, N), (1, N)
    else:
        if K % 2 or group < 2 or group % 2 or K % group:
            raise ValueError(f"int4 needs an even K and an even group dividing "
                             f"it, got K={K}, group={group}")
        want_q, want_s = (K // 2, N), (K // group, N)
    if tuple(q.shape) != want_q or tuple(scale.shape) != want_s:
        raise ValueError(f"bits={bits}: q must be {want_q} and scale {want_s}, "
                         f"got {tuple(q.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != _Q_DTYPES[bits] or scale.dtype != torch.float32:
        raise ValueError(f"bits={bits}: q must be {_Q_DTYPES[bits]} and scale "
                         f"float32, got {q.dtype} and {scale.dtype}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quant_matmul(x, q, scale, bits: int, group: int = 0):
    """x (M, K) float32/bfloat16 @ dequant(q, scale) -> fp32 (M, N), all on
    one CUDA device. Launches the kernel on the current stream; raises if
    the inputs do not fit it or the launch fails."""
    _check(x, q, scale, bits, group)
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), M, K, N, bits, group,
                          _DTYPE_CODES[x.dtype],
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed with CUDA error {err}")
    return out

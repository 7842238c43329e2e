"""Tree attention on the card: the wrapper of ``csrc/tree_attention.cu``,
the Hopper kernel that replaces the TPU kernel
``repro/kernels/tree_attention.py`` (``tree_attention`` ->
``_tree_kernel``).

It scores all N nodes of a draft tree in one launch, each under its own
(B, N, S) ancestor mask, with an online softmax over KV tiles; output is
fp32 (B, Hkv, N, G, hd). Any S is allowed. The plain version is
``kernels.ref.ref_tree_attention``; ``kernels.ops.tree_verify_attention``
chooses between the two by the device of its inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("tree_attention").tree_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, mask):
    if q.dim() != 5:
        raise ValueError(f"q must be (B, Hkv, N, G, hd), got {tuple(q.shape)}")
    B, Hkv, N, G, hd = q.shape
    S = k.shape[1] if k.dim() == 4 else -1
    if tuple(k.shape) != (B, S, Hkv, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"k/v must be (B, S, Hkv, hd) = ({B}, S, {Hkv}, "
                         f"{hd}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if tuple(mask.shape) != (B, N, S) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({B}, {N}, {S}), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in float32/bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "mask" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads K/V in 16-byte loads)")


def tree_attention(q, k, v, mask, softcap=None):
    """q (B, Hkv, N, G, hd), k/v (B, S, Hkv, hd), mask (B, N, S) bool, all
    on one CUDA device -> fp32 (B, Hkv, N, G, hd). Launches the kernel on
    the current stream; raises if the inputs do not fit it or the launch
    fails."""
    _check(q, k, v, mask)
    B, Hkv, N, G, hd = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, k.shape[1], Hkv, N, G, hd,
            _DTYPE_CODES[q.dtype], softcap is not None,
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_attention launch failed with CUDA error {err}")
    return out

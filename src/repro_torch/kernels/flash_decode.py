"""Flash decode on the card: the wrapper of ``csrc/flash_decode.cu``, the
Hopper kernel that replaces the TPU kernel ``repro/kernels/flash_decode.py``
(``flash_decode`` -> ``_decode_kernel``).

It attends one decode position of every query head over a KV cache; the G
query heads of a KV head share each K/V read, with an online softmax over
the slots. The slots of a (batch, kv head) are split across blocks
(``plan``) and the blocks' partial states combined by a second kernel in a
fixed order. Output is fp32 (B, Hkv, G, hd); any S is allowed. The plain
version is ``kernels.ref.ref_flash_decode``;
``kernels.ops.flash_decode_attention`` chooses between the two by the
device of its inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS, UNROLL = 128, 4       # as csrc/flash_decode.cu
BLOCKS_PER_SM = 4              # the split count aims at this many blocks


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("flash_decode").flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_per_block(G: int) -> int:
    """Query rows a block holds: the kernel's instances are 1, 2 and 4."""
    return 1 if G == 1 else 2 if G == 2 else 4


def plan(B, Hkv, G, hd, S, itemsize, sms):
    """(chunk, splits): slots per block, rounded up to whole steps of the
    block's loop, and blocks per (batch, kv head, row tile), so that the
    grid holds about ``BLOCKS_PER_SM`` blocks per SM while every block
    walks at least two steps."""
    lanes = min(32, hd * itemsize // 16)          # lanes reading one slot
    step = THREADS // lanes * UNROLL              # slots a block reads per step
    blocks = B * Hkv * -(-G // rows_per_block(G))
    want = -(-BLOCKS_PER_SM * sms // blocks)
    splits = max(1, min(want, -(-S // (2 * step))))
    chunk = -(-S // splits)
    chunk = -(-chunk // step) * step
    return chunk, -(-S // chunk)


def _check(q, k, v, mask):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hkv, G, hd), got {tuple(q.shape)}")
    B, Hkv, G, hd = q.shape
    S = k.shape[1] if k.dim() == 4 else -1
    if tuple(k.shape) != (B, S, Hkv, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"k/v must be (B, S, Hkv, hd) = ({B}, S, {Hkv}, "
                         f"{hd}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if tuple(mask.shape) != (B, S) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({B}, {S}), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
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
        if name in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads K/V in 16-byte loads)")


def flash_decode(q, k, v, mask, softcap=None):
    """q (B, Hkv, G, hd), k/v (B, S, Hkv, hd), mask (B, S) bool, all on one
    CUDA device -> fp32 (B, Hkv, G, hd). Launches the kernels on the current
    stream; raises if the inputs do not fit them or a launch fails."""
    _check(q, k, v, mask)
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    chunk, splits = plan(B, Hkv, G, hd, S, q.element_size(),
                         _sm_count(q.device.index or 0))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    part = None
    if splits > 1:
        part = torch.empty((B * Hkv * G, splits, hd + 2), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            B, S, Hkv, G, hd, _DTYPE_CODES[q.dtype], chunk, splits,
            softcap is not None, 0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    return out

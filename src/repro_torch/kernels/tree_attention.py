"""Tree attention on the card: the wrapper of ``csrc/tree_attention.cu``,
the Hopper kernel that replaces the TPU kernel
``repro/kernels/tree_attention.py`` (``tree_attention`` ->
``_tree_kernel``).

It scores all N nodes of a draft tree in one launch, each under its own
(B, N, S) ancestor mask, with an online softmax over the slots; the N*G
query rows of a KV head share each K/V read. bf16 at head dims 32-128
runs on the tensor cores, everything else on the CUDA cores. Where the
heads alone would leave SMs idle, the slots of a (batch, kv head) are
split across blocks (``plan``, as ``kernels.flash_decode`` does) and the
blocks' partial states combined by a second kernel in a fixed order.
Head dims 16, 32, 64, 128 and 256; output is fp32 (B, Hkv, N, G, hd);
any S is allowed. The
plain version is ``kernels.ref.ref_tree_attention``;
``kernels.ops.tree_verify_attention`` chooses between the two by the
device of its inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# as csrc/tree_attention.cu: the CUDA-core kernel's threads and slots per
# lane group and step; the tensor-core kernel's threads, query rows a block
# and slots a warp and step
THREADS, UNROLL = 128, 4
MMA_THREADS, MMA_ROWS, MMA_CHUNK = 256, 16, 16
# the split count aims at about this many blocks per SM (CUDA cores:
# rounded up; tensor cores: rounded down, its blocks being heavier)
BLOCKS_PER_SM = (4, 1)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("tree_attention").tree_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_tensor_cores(hd: int, itemsize: int) -> bool:
    """bf16 at head dims 32 to 128 runs the tensor-core kernel."""
    return itemsize == 2 and 32 <= hd <= 128


def rows_per_block(rows: int, hd: int, itemsize: int) -> int:
    """Query rows (of the N*G of a KV head) a block holds: 16 on the tensor
    cores, else the instances 1, 2, 4 and 8."""
    if on_tensor_cores(hd, itemsize):
        return MMA_ROWS
    return 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8


def step_slots(hd: int, itemsize: int) -> int:
    """Slots a block reads per step of its loop."""
    if on_tensor_cores(hd, itemsize):
        return MMA_THREADS // 32 * MMA_CHUNK
    lanes = min(32, hd * itemsize // 16)          # lanes reading one slot
    return THREADS // lanes * UNROLL


def plan(B, Hkv, N, G, hd, S, itemsize, sms):
    """(chunk, splits): slots per block, rounded up to whole steps of the
    block's loop, and blocks per (batch, kv head, row tile), so that the
    grid holds about ``BLOCKS_PER_SM`` blocks per SM while every block
    walks at least two steps."""
    mma = on_tensor_cores(hd, itemsize)
    step = step_slots(hd, itemsize)
    blocks = B * Hkv * -(-(N * G) // rows_per_block(N * G, hd, itemsize))
    if mma:
        want = max(1, BLOCKS_PER_SM[mma] * sms // blocks)
    else:
        want = -(-BLOCKS_PER_SM[mma] * sms // blocks)
    splits = max(1, min(want, -(-S // (2 * step))))
    chunk = -(-S // splits)
    chunk = -(-chunk // step) * step
    return chunk, -(-S // chunk)


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
    on one CUDA device -> fp32 (B, Hkv, N, G, hd). Launches the kernels on
    the current stream; raises if the inputs do not fit them or a launch
    fails."""
    _check(q, k, v, mask)
    B, Hkv, N, G, hd = q.shape
    S = k.shape[1]
    chunk, splits = plan(B, Hkv, N, G, hd, S, q.element_size(),
                         _sm_count(q.device.index or 0))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    part = None
    if splits > 1:
        part = torch.empty((B * Hkv * N * G, splits, hd + 2),
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            B, S, Hkv, N, G, hd, _DTYPE_CODES[q.dtype], chunk, splits,
            softcap is not None, 0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_attention launch failed with CUDA error {err}")
    return out

"""Flash decode on the card: the wrapper of ``csrc/flash_decode.cu``, the
Hopper kernel that replaces the TPU kernel ``repro/kernels/flash_decode.py``
(``flash_decode`` -> ``_decode_kernel``).

It attends one decode position of every query head over a KV cache, in one
launch. A block holds every query row of its (batch, kv head), up to
``ROW_TILE`` (only G > 16 takes further row tiles), so each K/V byte is read
once. ``plan`` splits the slots of a (batch, kv head) over at most
``MAX_SPLITS`` blocks that form one thread-block cluster, as many as the
card's SMs and its cluster occupancy (asked of the card) allow; the blocks
combine their online-softmax states through distributed shared memory in
rank order, so nothing goes through device memory between them and the
result is the same bit for bit from run to run. ``route`` says which
cores the kernel takes for a head dim and dtype: the tensor cores for bf16
at head dims 32-256, the CUDA cores for fp32 and head dim 16. Output is
fp32 (B, Hkv, G, hd); any S is allowed. The plain version is
``kernels.ref.ref_flash_decode``; ``kernels.ops.flash_decode_attention``
chooses between the two by the device of its inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launch import CTYPE, Launch, LaunchPlan

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# as csrc/flash_decode.cu
ROW_TILE, MAX_SPLITS = 16, 8


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("flash_decode").flash_decode_launch
    return typed_launch(fn)


def typed_launch(fn):
    """``fn``, a library's ``flash_decode_launch``, with its C types."""
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(hd: int, dtype: torch.dtype) -> str:
    """The cores the kernel takes: the tensor cores ("mma") for bf16 at head
    dims 32-256, else the CUDA cores ("simt"), as csrc/flash_decode.cu's
    by_route."""
    return "mma" if dtype == torch.bfloat16 and hd >= 32 else "simt"


def rows_per_block(G: int) -> int:
    """Query rows a block holds: all G of a KV head, up to ROW_TILE."""
    return min(G, ROW_TILE)


def group_tile(G: int, hd: int, dtype: torch.dtype) -> int:
    """The instance's GT: ROW_TILE on the tensor cores, else the next power
    of two >= min(G, ROW_TILE), as csrc/flash_decode.cu's by_route."""
    if route(hd, dtype) == "mma":
        return ROW_TILE
    rows = rows_per_block(G)
    return 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else \
        8 if rows <= 8 else 16


def row_tiles(G: int) -> int:
    return -(-G // ROW_TILE)


def chunk_slots(hd: int, itemsize: int) -> int:
    """Slots a warp stages at a time (the kernel's Smem::CS)."""
    return 8 if hd * itemsize >= 1024 else 16


def warps(hd: int, itemsize: int) -> int:
    """Warps of a block (the kernel's Smem::WARPS)."""
    return 4 if hd * itemsize >= 512 else 8


def plan(B, Hkv, G, hd, S, itemsize, sms, clusters):
    """(chunk, splits): slots per block, a multiple of the warps' chunk,
    and blocks per (batch, kv head, row tile), one cluster.
    ``clusters(splits)`` is how many clusters of that size the card holds
    at once (``_max_clusters``). Splits are the most, up to MAX_SPLITS,
    that keep the grid within one block per SM and every cluster resident
    at once, while every warp gets a chunk (a second block an SM, or a
    second wave of clusters, was slower on an H100); a longer cache gives
    each block a longer chunk, not more splits."""
    cs = chunk_slots(hd, itemsize)
    tiles = B * Hkv * row_tiles(G)
    splits = 1
    step = warps(hd, itemsize) * cs             # slots of one chunk a warp
    for s in range(2, min(MAX_SPLITS, S // step) + 1):
        if tiles * s > sms or tiles > clusters(s):
            break
        splits = s
    chunk = -(-S // splits)
    chunk = -(-chunk // cs) * cs
    return chunk, -(-S // chunk)


def launch_plan(B, Hkv, G, hd, S, dtype, sms, clusters) -> LaunchPlan:
    """The launch of ``flash_decode`` for q (B, Hkv, G, hd) and a cache of
    S slots in ``dtype``: ``plan``'s split into one cluster of ``splits``
    blocks per (batch, kv head, row tile), and the fp32 output."""
    itemsize = dtype.itemsize
    chunk, splits = plan(B, Hkv, G, hd, S, itemsize, sms, clusters)
    mma = route(hd, dtype) == "mma"
    gt = group_tile(G, hd, dtype)
    symbol = f"flash_decode_kernel<{CTYPE[dtype]}, {hd}, {1 if mma else 0}, {gt}>"
    launch = Launch(symbol, (splits * B * Hkv, row_tiles(G), 1),
                    32 * warps(hd, itemsize), splits)
    return LaunchPlan(
        "flash_decode", "flash_decode", (launch,),
        query=(min(G, ROW_TILE), hd, _DTYPE_CODES[dtype]), extent=S,
        chunk=chunk, splits=splits, step=chunk_slots(hd, itemsize),
        buffers=(("out", (B, Hkv, G, hd), torch.float32),),
        rows=(("k", hd * itemsize), ("v", hd * itemsize)))


@functools.lru_cache(maxsize=None)
def _max_clusters(index, G, hd, dtype_code, splits) -> int:
    """Clusters of ``splits`` blocks of the kernel's instance for (G, hd,
    dtype) that device ``index`` holds at once (the CUDA occupancy query,
    asked once per instance and size)."""
    fn = build.load("flash_decode").flash_decode_max_clusters
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(G, hd, dtype_code, splits, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"flash_decode occupancy query failed with CUDA "
                           f"error {err}")
    return n.value


def device_clusters(index, G, hd, dtype):
    """``clusters(splits)`` of ``plan`` for device ``index``."""
    def clusters(splits):
        return _max_clusters(index, min(G, ROW_TILE), hd, _DTYPE_CODES[dtype],
                             splits)
    return clusters


def device_plan(B, Hkv, G, hd, S, dtype, index):
    """``plan`` for a launch on device ``index``."""
    return plan(B, Hkv, G, hd, S, dtype.itemsize, _sm_count(index),
                device_clusters(index, G, hd, dtype))


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


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads it in 16-byte pieces)")


def flash_decode(q, k, v, mask, softcap=None):
    """q (B, Hkv, G, hd), k/v (B, S, Hkv, hd), mask (B, S) bool, all on one
    CUDA device -> fp32 (B, Hkv, G, hd). One kernel launch on the current
    stream, by ``route(hd, dtype)``; raises if the inputs do not fit the
    kernel or the launch fails."""
    _check(q, k, v, mask)
    _check_aligned(q=q, k=k, v=v)
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    index = q.device.index or 0
    p = launch_plan(B, Hkv, G, hd, S, q.dtype, _sm_count(index),
                    device_clusters(index, G, hd, q.dtype))
    out = p.allocate(q.device)["out"]
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, S, Hkv, G, hd, _DTYPE_CODES[q.dtype], p.chunk,
            p.splits, softcap is not None,
            0.0 if softcap is None else softcap,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    return out

"""Quantized matmul on the card: the wrapper of ``csrc/quant_matmul.cu``,
the Hopper kernel that replaces the TPU kernel
``repro/kernels/quant_matmul.py`` (``quant_matmul`` -> ``_int8_kernel`` and
``_int4_kernel``).

x (M, K) @ dequant(q, scale) -> fp32 (M, N), with the weight widened to
bf16 in registers and multiplied on the tensor cores: int8 q (K, N) with
per-column scales (1, N), or packed int4 q (K//2, N) with group scales
(K//group, N), the group a multiple of 16. Any M, K and N are allowed.
Where N is narrow, K is split into slices (``plan``) whose partial sums
the kernel adds in slice order; the plan depends on (K, N, bits, group)
only, never on M, so a row's result does not depend on the batch it runs
in. The plain version is ``kernels.ref.ref_quant_matmul``;
``kernels.ops.dequant_matmul`` chooses between the two by the device of
its inputs and applies the AWQ pre-scale to x first.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .launch import CTYPE, Launch, LaunchPlan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q_DTYPES = {8: torch.int8, 4: torch.uint8}
BN, BK = 64, 256       # columns per block, K rows per stage (as the source)
TARGET_BLOCKS = 256    # K is split until the column tiles give this many
MIN_ROWS = 8           # the smallest row tile: sizes the slice counters


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and typed once per process."""
    fn = build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_counters = {}  # repolint: ignore[RL003] one slice-counter buffer a device, left zeroed by every launch


def _slice_counters(device, n):
    """A zeroed int32 buffer of at least n counters on ``device``; the
    kernel leaves every counter it uses at zero again."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                              device=device)
    return buf


def plan(K, N, bits, group=0):
    """(chunk, slices): K rows per slice, a multiple of the kernel's stage
    (and for int4 of the group, so that no group straddles two slices),
    and the slice count ceil(K / chunk). K is split only as far as needed
    for the 64-column tiles to give ``TARGET_BLOCKS`` blocks. M is not an
    argument: every batch size runs the same slices."""
    unit = BK if bits == 8 else math.lcm(BK, group)
    units = -(-K // unit)
    want = -(-TARGET_BLOCKS // -(-N // BN))
    slices = max(1, min(want, units))
    chunk = -(-units // slices) * unit
    return chunk, -(-K // chunk)


def rows_per_block(M: int, dtype: torch.dtype) -> int:
    """Rows of x a block holds (csrc/quant_matmul.cu's by_rows): 8, 16, 32
    or, for bf16 x above 32 rows, 64."""
    if M <= 8:
        return 8
    if M <= 16:
        return 16
    return 32 if M <= 32 or dtype == torch.float32 else 64


def launch_plan(M, K, N, bits, group, dtype) -> LaunchPlan:
    """The launch of ``quant_matmul`` for x (M, K) in ``dtype`` and an
    int8 or int4 (K, N) weight: the instance by rows, ``plan``'s K slices
    as the grid's z (64-row tiles walk all slices in one block), and the
    fp32 output with, where slices meet in device memory, their fp32
    partial sums (the slice counters are a persistent buffer of their
    own)."""
    group = group if bits == 4 else 0
    chunk, slices = plan(K, N, bits, group)
    bm = rows_per_block(M, dtype)
    threads = 512 if bm == 64 and bits == 8 else 256
    bn = threads // 32 * 32 // 4            # the source's Shape::BN
    walks = bm == 64
    launch = Launch(f"quant_matmul_kernel<{CTYPE[dtype]}, {bm}, {bits}>",
                    (-(-N // bn), -(-M // bm), 1 if walks else slices),
                    threads)
    buffers = [("out", (M, N), torch.float32)]
    if slices > 1 and not walks:
        buffers.append(("part", (slices, M, N), torch.float32))
    return LaunchPlan(
        f"quant_matmul_int{bits}", "quant_matmul", (launch,),
        query=(M, bits, _DTYPE_CODES[dtype]), extent=K, chunk=chunk,
        splits=slices, step=BK if bits == 8 else math.lcm(BK, group),
        buffers=tuple(buffers),
        rows=(("q", N), ("x", K * dtype.itemsize)))


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
        if K % 2 or group < 16 or group % 16 or K % group:
            raise ValueError(f"int4 needs a group that is a multiple of 16 "
                             f"and divides K, got K={K}, group={group}")
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
    group = group if bits == 4 else 0
    p = launch_plan(M, K, N, bits, group, x.dtype)
    bufs = p.allocate(x.device)
    out, part, cnt = bufs["out"], bufs.get("part"), None
    if part is not None:
        # partial sums of the slices; bf16 x above 32 rows runs 64-row
        # tiles, each walking all slices itself
        cnt = _slice_counters(x.device, -(-N // BN) * -(-M // MIN_ROWS))
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                          out.data_ptr(),
                          None if part is None else part.data_ptr(),
                          None if cnt is None else cnt.data_ptr(),
                          M, K, N, bits, group, _DTYPE_CODES[x.dtype], p.chunk,
                          p.splits, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed with CUDA error {err}")
    return out

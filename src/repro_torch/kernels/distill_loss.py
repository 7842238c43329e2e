"""Distillation-loss kernels on the card: the wrappers of
``csrc/distill_loss.cu``, the Hopper kernels that replace the TPU kernels of
``repro/kernels/distill_loss.py`` (``row_logsumexp`` -> ``_lse_kernel``,
``loss_terms`` -> ``_terms_kernel``, ``loss_grad`` -> ``_grad_kernel``).

Student and teacher logits are fp32 (N, V) with unit stride along V and any
row stride (a row may start off a 16-byte boundary); row statistics are fp32
(N,); ``mu`` and ``inv_sigma`` are 1-element fp32 tensors on the card, read
there by the kernels. The plain versions are ``kernels.ref.ref_logsumexp``,
``ref_loss_terms`` and ``ref_loss_grad``; ``kernels.ops`` chooses between
the two by the device of its inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launch import Launch, LaunchPlan

MODES = {"kld": 0, "tvd": 1, "tvdpp": 2}
THREADS = 256          # one block of THREADS a row, as the source
#: the kernels by name: (the query's index, the instance's symbol, shape
#: of the output given N and V)
KERNELS = {"row_logsumexp": (0, "row_logsumexp_kernel", lambda N, V: (N,)),
           "loss_terms": (1, "loss_terms_kernel<{}>", lambda N, V: (4, N)),
           "loss_grad": (2, "loss_grad_kernel<{}>", lambda N, V: (N, V))}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points, built and typed once per process."""
    lib = build.load("distill_loss")
    for fn, args in (
            (lib.row_logsumexp_launch, [_P, _L, _P, _I, _I, _P]),
            (lib.loss_terms_launch, [_P, _L, _P, _L] + [_P] * 8 + [_I, _I, _I, _P]),
            (lib.loss_grad_launch, [_P, _L, _P, _L] + [_P] * 7 + [_I, _I, _I, _P])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def launch_plan(kernel, N, V, mode="tvdpp") -> LaunchPlan:
    """The launch of ``kernel`` (a ``KERNELS`` name) over (N, V) fp32
    logits: one block a row walking all V, and its fp32 output."""
    which, symbol, out_shape = KERNELS[kernel]
    code = _mode(mode)
    return LaunchPlan(
        kernel, "distill_loss",
        (Launch(symbol.format(code), (N, 1, 1), THREADS),),
        query=(which, code), extent=V, chunk=V,
        buffers=(("out", out_shape(N, V), torch.float32),),
        rows=(("logits", V * 4),))


def _check_logits(name, x, like=None):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} must be fp32 (N, V), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if like is not None and x.shape != like.shape:
        raise ValueError(f"{name} must have shape {tuple(like.shape)}, got "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 1 or (x.shape[1] > 1 and x.stride(1) != 1) or \
            (x.shape[0] > 1 and x.stride(0) < x.shape[1]):
        raise ValueError(f"{name} needs unit stride along V and rows that do "
                         f"not overlap, got strides {x.stride()}")


def _check_vec(name, v, n):
    if tuple(v.shape) != (n,) or v.dtype != torch.float32 or \
            not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous fp32 ({n},), got "
                         f"{v.dtype} {tuple(v.shape)}")


def _check_scalar(name, v):
    if v.numel() != 1 or v.dtype != torch.float32:
        raise ValueError(f"{name} must be a 1-element fp32 tensor, got "
                         f"{v.dtype} {tuple(v.shape)}")


def _check_device(**tensors):
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on one CUDA device with the "
                             f"others, got {t.device}")


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    return MODES[mode]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def row_logsumexp(x):
    """x fp32 (N, V) on the card -> fp32 (N,) logsumexp of each row."""
    _check_logits("x", x)
    _check_device(x=x)
    N, V = x.shape
    out = launch_plan("row_logsumexp", N, V).allocate(x.device)["out"]
    with torch.cuda.device(x.device):
        err = _lib().row_logsumexp_launch(x.data_ptr(), x.stride(0),
                                          out.data_ptr(), N, V, _stream(x))
    _raise_on(err, "row_logsumexp")
    return out


def loss_terms(s, t, lse_s, lse_t, mu, inv_sigma, mode="tvdpp"):
    """-> per-row (loss, c, sum p*r, sum p*r^2), each fp32 (N,)."""
    code = _mode(mode)
    _check_logits("s", s)
    _check_logits("t", t, like=s)
    N, V = s.shape
    for name, v in (("lse_s", lse_s), ("lse_t", lse_t)):
        _check_vec(name, v, N)
    for name, v in (("mu", mu), ("inv_sigma", inv_sigma)):
        _check_scalar(name, v)
    _check_device(s=s, t=t, lse_s=lse_s, lse_t=lse_t, mu=mu,
                  inv_sigma=inv_sigma)
    out = launch_plan("loss_terms", N, V, mode).allocate(s.device)["out"]
    with torch.cuda.device(s.device):
        err = _lib().loss_terms_launch(
            s.data_ptr(), s.stride(0), t.data_ptr(), t.stride(0),
            lse_s.data_ptr(), lse_t.data_ptr(), mu.data_ptr(),
            inv_sigma.data_ptr(), *(o.data_ptr() for o in out), N, V, code,
            _stream(s))
    _raise_on(err, "loss_terms")
    return tuple(out)


def loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, mode="tvdpp"):
    """-> dL/ds fp32 (N, V), contiguous, given per-row cotangents g_rows."""
    code = _mode(mode)
    _check_logits("s", s)
    _check_logits("t", t, like=s)
    N, V = s.shape
    for name, v in (("lse_s", lse_s), ("lse_t", lse_t), ("c", c),
                    ("g_rows", g_rows)):
        _check_vec(name, v, N)
    for name, v in (("mu", mu), ("inv_sigma", inv_sigma)):
        _check_scalar(name, v)
    _check_device(s=s, t=t, lse_s=lse_s, lse_t=lse_t, c=c, g_rows=g_rows,
                  mu=mu, inv_sigma=inv_sigma)
    out = launch_plan("loss_grad", N, V, mode).allocate(s.device)["out"]
    with torch.cuda.device(s.device):
        err = _lib().loss_grad_launch(
            s.data_ptr(), s.stride(0), t.data_ptr(), t.stride(0),
            lse_s.data_ptr(), lse_t.data_ptr(), c.data_ptr(),
            g_rows.data_ptr(), mu.data_ptr(), inv_sigma.data_ptr(),
            out.data_ptr(), N, V, code, _stream(s))
    _raise_on(err, "loss_grad")
    return out

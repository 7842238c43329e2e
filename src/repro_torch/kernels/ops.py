"""Public wrappers over the port's kernels (``repro.kernels.ops``): tree
attention, the quantized matmul, and the fused distillation loss assembled
from three kernels.

Each wrapper runs the kernel's plain version for tensors that lie on the
CPU, and for CUDA tensors launches the kernel or raises: nothing on the
card falls back to the plain version. ``LAUNCHES`` counts, per kernel,
the launches made through these wrappers, so that a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import torch

from . import distill_loss as dk
from . import quant_matmul as qk
from . import ref
from . import tree_attention as tk

LAUNCHES = {"tree_attention": 0, "row_logsumexp": 0, "loss_terms": 0,
            "loss_grad": 0, "quant_matmul_int8": 0, "quant_matmul_int4": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tree_verify_attention(q, k, v, mask, softcap=None):
    """q (B, Hkv, N, G, hd), k/v (B, S, Hkv, hd), mask (B, N, S) -> fp32
    (B, Hkv, N, G, hd): every node of a speculative draft tree scored in
    one kernel launch (oracle: ``ref.ref_tree_attention``)."""
    if q.device.type == "cpu":
        return ref.ref_tree_attention(q, k, v, mask, softcap)
    out = tk.tree_attention(q, k, v, mask, softcap)
    LAUNCHES["tree_attention"] += 1
    return out


# ------------------------------------------------------ quantized matmul

def dequant_matmul(x, qw):
    """x (..., K) @ QWeight (K, N) -> (..., N) fp32 (oracle:
    ``ref.ref_quant_matmul``). The AWQ pre-scale multiplies x in x's dtype
    first, as the reference's wrapper does; the kernel then reads only the
    int8/int4 weight bytes and their scales."""
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    if qw.pre is not None:
        xm = xm * qw.pre[None, :].to(xm.dtype)
    if xm.device.type == "cpu":
        out = ref.ref_quant_matmul(xm, qw.q, qw.scale, qw.bits, qw.group)
    else:
        out = qk.quant_matmul(xm.contiguous(), qw.q, qw.scale, qw.bits,
                              qw.group)
        LAUNCHES[f"quant_matmul_int{qw.bits}"] += 1
    return out.reshape(*lead, qw.out_dim)


# ------------------------------------------------------ distillation loss

def row_logsumexp(x):
    """(N, V) fp32 -> (N,) fp32 (oracle: ``ref.ref_logsumexp``)."""
    if x.device.type == "cpu":
        return ref.ref_logsumexp(x)
    out = dk.row_logsumexp(x)
    LAUNCHES["row_logsumexp"] += 1
    return out


def loss_terms(s, t, lse_s, lse_t, mu, inv_sigma, mode="tvdpp"):
    """-> per-row (loss, c, sum p*r, sum p*r^2) (oracle:
    ``ref.ref_loss_terms``)."""
    if s.device.type == "cpu":
        return ref.ref_loss_terms(s, t, lse_s, lse_t, mu, inv_sigma, mode)
    out = dk.loss_terms(s, t, lse_s, lse_t, mu, inv_sigma, mode)
    LAUNCHES["loss_terms"] += 1
    return out


def loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, mode="tvdpp"):
    """-> dL/ds (N, V) fp32 (oracle: ``ref.ref_loss_grad``)."""
    if s.device.type == "cpu":
        return ref.ref_loss_grad(s, t, lse_s, lse_t, c, g_rows, mu,
                                 inv_sigma, mode)
    out = dk.loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, mode)
    LAUNCHES["loss_grad"] += 1
    return out


class _DistillCore(torch.autograd.Function):
    """The masked mean of the per-row loss with ``mu`` and ``inv_sigma``
    given: two ``row_logsumexp`` and one ``loss_terms`` forward, one
    ``loss_grad`` backward (the reference's ``_core_loss`` custom VJP). The
    teacher is frozen, so only the student logits get a gradient."""

    @staticmethod
    def forward(ctx, s, t, mask, mu, inv_sigma, mode):
        lse_s, lse_t = row_logsumexp(s), row_logsumexp(t)
        loss_rows, c, _, _ = loss_terms(s, t, lse_s, lse_t, mu, inv_sigma,
                                        mode)
        n = mask.sum().clamp(min=1.0)
        ctx.mode = mode
        ctx.save_for_backward(s, t, lse_s, lse_t, c, mask, mu, inv_sigma, n)
        return (loss_rows * mask).sum() / n

    @staticmethod
    def backward(ctx, g):
        s, t, lse_s, lse_t, c, mask, mu, inv_sigma, n = ctx.saved_tensors
        g_rows = (g * mask / n).float()
        ds = loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, ctx.mode)
        return ds.to(s.dtype), None, None, None, None, None


def distill_core(mode, s, t, mask, mu, inv_sigma):
    """``_DistillCore`` on (N, V) logits and an (N,) mask, with the global
    ``mu``/``inv_sigma`` (1-element tensors) that a caller computed."""
    return _DistillCore.apply(s.float(), t.float(), mask.float(), mu,
                              inv_sigma, mode)


def fused_distill_loss(mode: str, s_logits, t_logits, mask):
    """Scalar distillation loss (kld, tvd or tvdpp) through the kernels.

    s_logits/t_logits: (N, V); mask: (N,). For tvdpp a first sweep gives the
    global p-weighted reward moments (paper Eq. 1 normalisation), used as
    constants: ``inv_sigma = rsqrt(max(var, 1e-12) + 1e-6)``, as the
    reference's ``fused_distill_loss`` computes it."""
    s, t, mask = s_logits.float(), t_logits.float(), mask.float()
    dev = s.device
    mu = torch.zeros((1,), dtype=torch.float32, device=dev)
    inv_sigma = torch.ones((1,), dtype=torch.float32, device=dev)
    if mode == "tvdpp":
        with torch.no_grad():
            lse_s, lse_t = row_logsumexp(s), row_logsumexp(t)
            _, _, r1, r2 = loss_terms(s, t, lse_s, lse_t, mu, inv_sigma,
                                      "tvdpp")
            n = mask.sum().clamp(min=1.0)
            mu = ((r1 * mask).sum() / n).reshape(1)
            var = (r2 * mask).sum() / n - mu * mu
            inv_sigma = torch.rsqrt(var.clamp(min=1e-12) + 1e-6)
    return distill_core(mode, s, t, mask, mu, inv_sigma)

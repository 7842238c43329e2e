"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

They are the definitions: each kernel is held against its plain version
on the card, and the wrappers in ``kernels.ops`` run the plain version for
tensors that lie on the CPU."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30     # finite sentinel: a fully masked row averages V, not NaN


def ref_tree_attention(q, k, v, mask, softcap=None):
    """q: (B, Hkv, N, G, hd); k/v: (B, S, Hkv, hd); mask: (B, N, S) bool.

    Per-node masked attention in float32; returns (B, Hkv, N, G, hd) fp32."""
    hd = q.shape[-1]
    s = torch.einsum("bhngd,bshd->bhngs", q.float(), k.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, :, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhngs,bshd->bhngd", p, v.float())


def ref_flash_decode(q, k, v, mask, softcap=None):
    """q: (B, Hkv, G, hd); k/v: (B, S, Hkv, hd); mask: (B, S) bool.

    One decode position's GQA attention in float32; returns (B, Hkv, G, hd)
    fp32. A fully masked row averages V over all S slots."""
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


# ----------------------------------------------------- distillation loss
# The plain versions of csrc/distill_loss.cu. Like the kernels, they take
# each row's logsumexp as an input and form p and q as exp(x - lse), so that
# on the card the two differ only in the order of their sums. mu and
# inv_sigma are 1-element tensors, as the kernels read them.

def ref_logsumexp(x):
    """(N, V) -> fp32 (N,): the row max m, then m + log(sum(exp(x - m)))."""
    x = x.float()
    m = x.amax(-1, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)))[:, 0]


def _probs(x, lse):
    return torch.exp(x.float() - lse[:, None])


def _weight(mode, p, q, mu, inv_sigma):
    if mode == "tvdpp":
        return -((q > p).float() - mu) * inv_sigma
    if mode == "tvd":
        return 0.5 * torch.sign(p - q)
    raise ValueError(mode)


def ref_loss_terms(s, t, lse_s, lse_t, mu, inv_sigma, mode="tvdpp"):
    """Per-row (loss, c = sum p*w, sum p*r, sum p*r^2), r = 1{q > p}; for
    tvdpp the loss is c, for kld c is 0."""
    p, q = _probs(s, lse_s), _probs(t, lse_t)
    r = (q > p).float()
    if mode == "kld":
        lq = t.float() - lse_t[:, None]
        lp = s.float() - lse_s[:, None]
        loss = (q * (lq - lp)).sum(-1)
        c = torch.zeros_like(loss)
    else:
        c = (p * _weight(mode, p, q, mu, inv_sigma)).sum(-1)
        loss = c if mode == "tvdpp" else (0.5 * (q - p).abs()).sum(-1)
    return loss, c, (p * r).sum(-1), (p * r * r).sum(-1)


def ref_loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, mode="tvdpp"):
    """dL/ds (N, V) fp32 given per-row cotangents: g * p * (w - c), or
    g * (p - q) for kld."""
    p, q = _probs(s, lse_s), _probs(t, lse_t)
    g = g_rows[:, None]
    if mode == "kld":
        return g * (p - q)
    return g * p * (_weight(mode, p, q, mu, inv_sigma) - c[:, None])


def ref_distill_loss(mode, s, t, mask):
    """Scalar loss: equals ``core.losses`` on the same inputs."""
    from ..core import losses as L
    fn = {"tvdpp": L.tvdpp, "tvd": L.tvd, "kld": L.kld}[mode]
    return fn(s, t, mask)


# ------------------------------------------------------- quantized matmul
# The plain versions of csrc/quant_matmul.cu (layouts: quant/qweight.py).

def ref_dequant(q, scale, bits, group):
    """Quantized weight -> (K, N) fp32. int8: q (K, N) int8, scale (1, N);
    int4: q (K//2, N) uint8 packed (even K row = low nibble), scale
    (K//group, N)."""
    if bits == 8:
        return q.float() * scale
    lo = (q & 0xF).to(torch.int32)
    hi = ((q >> 4) & 0xF).to(torch.int32)
    lo = lo - 16 * (lo >= 8).to(torch.int32)
    hi = hi - 16 * (hi >= 8).to(torch.int32)
    half, n = q.shape
    vals = torch.stack([lo, hi], 1).reshape(2 * half, n).float()
    return vals * scale.repeat_interleave(group, dim=0)


def ref_quant_matmul(x, q, scale, bits, group, pre=None):
    """Dequantize, then matmul in fp32: x (M, K) -> (M, N) fp32. ``pre``
    (K,) is the AWQ activation pre-scale, applied to x."""
    x = x.float()
    if pre is not None:
        x = x * pre[None, :]
    return x @ ref_dequant(q, scale, bits, group)

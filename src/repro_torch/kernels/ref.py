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

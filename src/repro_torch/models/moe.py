"""Mixture-of-experts FFN with top-k routing (``repro.models.moe``):
granite-moe-3b-a800m and grok-1-314b.

Dispatch is sort-based with a capacity per expert (Switch/GShard-style
token dropping), as in the reference: the (token, expert) assignments are
sorted by expert with a stable sort, the first C of each expert fill its
rows of an (E, C, d) buffer, and the rest go to an overflow row whose
output is zero. C depends on the number of tokens in the call, so a
token's output can depend on its batchmates wherever an assignment drops;
with ``moe_capacity_factor = E / k``, C is at least the token count and
nothing drops. The port runs the reference's path without a mesh; its
``shard_map`` and weight-stationary paths wait for the sharding item of
the ROADMAP. The experts are three batched matmuls, as the reference's
``einsum``s: no kernel of the reference computes them.

On the card the output does not depend on the order of atomic adds: each
slot of the buffer takes at most one token, so it is filled by a copy,
and each token's k weighted expert outputs are brought back to (N, k, d)
and summed over k in the order of its top-k choices.

``_moe_dense`` (every expert on every token, gated combine) is the
reference's correctness oracle.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import trunc_normal


def init_moe(gen, cfg, dtype, device):
    """Router (d, E), always float32; expert banks ``w_gate``/``w_up``
    (E, d, f) and ``w_down`` (E, f, d) in ``dtype``, drawn from ``gen`` in
    that order."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": trunc_normal(gen, (d, E), 1.0 / math.sqrt(d), torch.float32,
                               device),
        "w_gate": trunc_normal(gen, (E, d, f), 1.0 / math.sqrt(d), dtype, device),
        "w_up": trunc_normal(gen, (E, d, f), 1.0 / math.sqrt(d), dtype, device),
        "w_down": trunc_normal(gen, (E, f, d), 1.0 / math.sqrt(f), dtype, device),
    }


def capacity(num_tokens: int, cfg) -> int:
    """Slots per expert for a call over ``num_tokens`` tokens: the
    reference's ceil(N * k / E * cf), rounded up to a multiple of 8, at
    least 8."""
    C = int(math.ceil(num_tokens * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.moe_capacity_factor))
    return max(8, -(-C // 8) * 8)


def _route(x2d, router_w, k, with_aux=True):
    """x2d (N, d) -> (gates (N, k), experts (N, k), aux): float32 logits
    and softmax, the top k renormalised, and the Switch load-balance aux,
    whose gradient flows through the mean probabilities only (None
    without ``with_aux``: serving drops it, and it costs six kernels a
    layer)."""
    probs = torch.softmax(x2d.float() @ router_w, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    if not with_aux:
        return gates, experts, None
    E = router_w.shape[1]
    frac_routed = F.one_hot(experts, E).float().sum(1).mean(0)     # (E,)
    aux = E * (frac_routed * probs.mean(0)).sum()
    return gates, experts, aux


def _expert_ffn(w_gate, w_up, w_down, buf):
    """buf (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(F.silu(g) * u, w_down.to(buf.dtype))


def _dispatch(experts, E, C):
    """The slot in the flat (E * C + 1) buffer of every assignment, in
    the assignments' own (token-major) order: the assignments sorted by
    expert (stable), numbered within their expert, and those past C sent
    to the overflow row E * C."""
    fe = experts.reshape(-1)
    n = fe.numel()
    fe_s, order = torch.sort(fe, stable=True)
    start = torch.searchsorted(fe_s, torch.arange(E, device=fe.device,
                                                  dtype=fe_s.dtype))
    pos = torch.arange(n, device=fe.device) - start[fe_s]
    slot_s = torch.where(pos < C, fe_s * C + pos, E * C)
    return torch.empty_like(slot_s).index_copy_(0, order, slot_s)


def _moe_local(params, x2d, cfg, with_aux=True):
    """Capacity-dropping MoE over the call's tokens. x2d (N, d) -> (y (N,
    d), aux)."""
    N, d = x2d.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates, experts, aux = _route(x2d, params["router"], k, with_aux)
    C = capacity(N, cfg)
    slot = _dispatch(experts, E, C)                               # (N * k,)
    # kept slots are distinct, so a copy fills them; the overflow row is
    # never read
    buf = x2d.new_zeros((E * C + 1, d)).index_copy(
        0, slot, x2d.repeat_interleave(k, dim=0))
    out = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                      buf[:E * C].reshape(E, C, d))
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    keep = (slot < E * C).to(gates.dtype)
    weight = (gates.reshape(-1) * keep).to(out.dtype)
    contrib = out_flat[slot] * weight[:, None]
    return contrib.reshape(N, k, d).sum(1), aux


def _moe_dense(params, x2d, cfg, with_aux=True):
    """Dense-dispatch oracle: every expert on every token."""
    N, d = x2d.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates, experts, aux = _route(x2d, params["router"], k, with_aux)
    all_out = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                          x2d.expand(E, N, d))                    # (E, N, d)
    combine = torch.zeros((N, E), dtype=torch.float32,
                          device=x2d.device).scatter_add(1, experts, gates)
    return torch.einsum("ne,end->nd", combine.to(x2d.dtype), all_out), aux


def moe_ffn(params, x, cfg, dense: bool = False, with_aux: bool = True):
    """x (B, S, d) -> (y (B, S, d), aux; None without ``with_aux``): the
    reference's ``moe_ffn`` without a mesh, over all B * S tokens of the
    call."""
    B, S, d = x.shape
    fn = _moe_dense if dense else _moe_local
    y, aux = fn(params, x.reshape(B * S, d), cfg, with_aux)
    return y.reshape(B, S, d), aux

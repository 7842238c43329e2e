"""Mixture-of-experts FFN with top-k routing (``repro.models.moe``):
granite-moe-3b-a800m and grok-1-314b.

Dispatch is sort-based with a capacity per expert (Switch/GShard-style
token dropping), as in the reference: the (token, expert) assignments are
sorted by expert with a stable sort, the first C of each expert fill its
rows of an (E, C, d) buffer, and the rest go to an overflow row whose
output is zero. C depends on the number of tokens in the call, so a
token's output can depend on its batchmates wherever an assignment drops;
with ``moe_capacity_factor = E / k``, C is at least the token count and
nothing drops. The experts are three batched matmuls, as the reference's
``einsum``s: no kernel of the reference computes them.

With a mesh installed (``sharding.context``) ``moe_ffn`` runs the
reference's ``shard_map`` regions as local shards plus explicit functional
collectives over the mesh dims' process groups, in the reference's order:
the baseline's ZeRO gather of one layer's experts over the data axes, the
local ``_moe_local`` on the rank's tokens, a psum over ``model`` (the
w_down partial sums over the rank's d_ff slice) and a pmean of the aux
over the data axes; the optimized profile's weight-stationary path at
``tokens_per_chip <= 64`` (``_moe_weight_stationary``). On plain tensors
(a real process group: gloo on the CPU, NCCL on the card) ``params`` and
``x`` are the rank's blocks of the region's inputs, its rows of a batch
split over the data axes. On DTensors (the dry run's trace on the fake
backend, or a real group) they are global: the region redistributes them
to its input layout, takes the local shards, and wraps its outputs back;
there a batch the data axes do not divide runs without a data split, as
in the reference.

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

from ..sharding import context
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
    C = math.ceil(num_tokens * cfg.num_experts_per_tok / cfg.num_experts
                  * cfg.moe_capacity_factor)
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


def _fill(x2d, slot, k, E, C):
    """The (E, C, d) expert buffer: each kept assignment's token in its
    slot. Kept slots are distinct, so a copy fills them; the overflow row
    is never read."""
    d = x2d.shape[1]
    buf = x2d.new_zeros((E * C + 1, d)).index_copy(
        0, slot, x2d.repeat_interleave(k, dim=0))
    return buf[:E * C].reshape(E, C, d)


def _combine(out, slot, gates, N, k):
    """out (E, C, w) -> (N, w): each token's kept expert outputs weighted
    by their gates, summed over its k choices in their order."""
    E, C, w = out.shape
    out_flat = torch.cat([out.reshape(E * C, w), out.new_zeros((1, w))])
    keep = (slot < E * C).to(gates.dtype)
    weight = (gates.reshape(-1) * keep).to(out.dtype)
    contrib = out_flat[slot] * weight[:, None]
    return contrib.reshape(N, k, w).sum(1)


def _moe_local(params, x2d, cfg, with_aux=True):
    """Capacity-dropping MoE over the call's tokens. x2d (N, d) -> (y (N,
    d), aux)."""
    N, d = x2d.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates, experts, aux = _route(x2d, params["router"], k, with_aux)
    C = capacity(N, cfg)
    slot = _dispatch(experts, E, C)                               # (N * k,)
    out = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                      _fill(x2d, slot, k, E, C))
    return _combine(out, slot, gates, N, k), aux


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
    reference's ``moe_ffn``. Without a mesh, over all B * S tokens of the
    call; with one, each data shard's tokens with a capacity of their own
    (the module's docstring)."""
    B, S, d = x.shape
    fn = _moe_dense if dense else _moe_local
    mesh = context.get_mesh()
    daxes = context.data_axes()
    if mesh is None or not daxes:
        y, aux = fn(params, x.reshape(B * S, d), cfg, with_aux)
        return y.reshape(B, S, d), aux
    maxis = context.model_axis()
    gather_axes = daxes                    # fsdp storage axes (always)
    sizes = context.mesh_sizes(mesh)
    dsize = math.prod(sizes[a] for a in daxes)
    sharded = context.is_dtensor(x)
    if sharded and B % dsize != 0:
        # batch 1 decode (long_500k): the batch cannot split over data, so
        # the tokens are replicated over the data shards and the region
        # runs without a data split
        daxes, dsize = (), 1
    # the optimized profile's decode path: a few tokens move through the
    # (data x model)-sharded weights instead of the weights to the tokens
    tokens_per_chip = (B * S / dsize) if sharded else B * S
    ws = context.optimized() and tokens_per_chip <= 64 and not dense
    x_place = _placements(mesh, {0: daxes} if daxes else {})
    w_place = {"router": _placements(mesh, {}),
               "w_gate": _placements(mesh, {1: gather_axes, 2: (maxis,)}),
               "w_up": _placements(mesh, {1: gather_axes, 2: (maxis,)}),
               "w_down": _placements(mesh, {1: (maxis,), 2: gather_axes})}
    if sharded:
        # each rank's router gradient is a partial sum: over the data
        # shards' tokens, and over the model ranks' f slices whose outputs
        # the gates weigh (over the data ranks' d slices on the
        # weight-stationary path)
        from torch.distributed.tensor import Partial, Replicate
        router_grad = tuple(Partial() if not ws or a in gather_axes
                            else Replicate() for a in mesh.mesh_dim_names)
        p = {n: _local(params[n], mesh, w_place[n],
                       router_grad if n == "router" else None)
             for n in w_place}
        xl = _local(x, mesh, x_place)
    else:
        p, xl = params, x
    if ws:
        y, aux = _moe_weight_stationary(p, xl, cfg, mesh, daxes, gather_axes,
                                        maxis, with_aux)
    else:
        y, aux = _moe_zero_gather(p, xl, cfg, fn, mesh, daxes, gather_axes,
                                  maxis, with_aux)
    if sharded:
        from torch.distributed.tensor import DTensor
        y = DTensor.from_local(
            y, mesh, x_place, run_check=False, shape=x.shape,
            stride=torch.empty(x.shape, device="meta").stride())
        if aux is not None:
            aux = DTensor.from_local(aux, mesh, _placements(mesh, {}),
                                     run_check=False)
    return y, aux


def _placements(mesh, dims):
    """DTensor placements on ``mesh``: ``Shard(i)`` on the mesh dims named
    by ``dims[i]`` (a tensor dim split over them in mesh order, as a
    ``PartitionSpec`` entry), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {a: i for i, axes in dims.items() for a in axes}
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def _local(t, mesh, place, grad=None):
    """The rank's shard of DTensor ``t`` laid out as ``place``: the
    region's input, as ``shard_map``'s in_specs give it; its gradient
    comes back with the placements ``grad`` (default ``place``)."""
    return t.redistribute(mesh, place).to_local(grad_placements=grad)


def _combined_axis_index(mesh, axes):
    """This rank's linear index over a tuple of mesh axes (row-major)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = context.mesh_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _moe_zero_gather(p, xl, cfg, fn, mesh, daxes, gather_axes, maxis,
                     with_aux):
    """The baseline region on the rank's blocks: the ZeRO-3 gather of this
    layer's expert shards over the data axes (transient: one layer's
    experts live at a time), the local MoE on the rank's tokens, the psum
    of the w_down f-contraction partials over ``model`` and the pmean of
    the aux over the data axes."""
    Bl, Sl, d = xl.shape
    p = dict(p)
    for a in gather_axes:
        p["w_gate"] = context.all_gather(p["w_gate"], 1, mesh, a)
        p["w_up"] = context.all_gather(p["w_up"], 1, mesh, a)
        p["w_down"] = context.all_gather(p["w_down"], 2, mesh, a)
    y, aux = fn(p, xl.reshape(Bl * Sl, d), cfg, with_aux)
    y = context.all_reduce(y, "sum", mesh, (maxis,))
    if daxes and aux is not None:
        dsize = math.prod(context.mesh_sizes(mesh)[a] for a in daxes)
        aux = context.all_reduce(aux, "sum", mesh, daxes) / dsize
    return y.reshape(Bl, Sl, d), aux


def _moe_weight_stationary(p, xl, cfg, mesh, daxes, gather_axes, maxis,
                           with_aux):
    """Decode-optimized region: activations move, weights stay sharded.

    The rank's weight blocks are w_gate/w_up (E, d/D, F/M) and w_down (E,
    F/M, d/D). The tokens are gathered over the data shards (a decode's
    few), routed identically everywhere (the router is whole), dispatched
    into an (E, C, d) buffer, whose d slice of this rank meets its weight
    blocks in partial matmuls: a psum over the data axes completes the d
    contraction, one over ``model`` the F contraction. Each rank combines
    its d slice of every token, the slices are gathered, and the rank keeps
    its own token rows. Per layer O(N d + E C F/M) bytes move instead of
    the baseline's expert weights."""
    Bl, Sl, d = xl.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    sizes = context.mesh_sizes(mesh)
    d_shard = d // math.prod(sizes[a] for a in gather_axes)
    x_all = xl.reshape(Bl * Sl, d)
    for a in daxes:
        x_all = context.all_gather(x_all, 0, mesh, a)
    N = x_all.shape[0]
    gates, experts, aux = _route(x_all, p["router"], k, with_aux)
    C = capacity(N, cfg)
    slot = _dispatch(experts, E, C)
    buf = _fill(x_all, slot, k, E, C)
    didx = _combined_axis_index(mesh, gather_axes)
    buf_d = buf[:, :, didx * d_shard:(didx + 1) * d_shard]
    g = torch.bmm(buf_d, p["w_gate"].to(buf.dtype))
    u = torch.bmm(buf_d, p["w_up"].to(buf.dtype))
    # complete the d contraction
    g = context.all_reduce(g, "sum", mesh, gather_axes)
    u = context.all_reduce(u, "sum", mesh, gather_axes)
    y_d = torch.bmm(F.silu(g) * u, p["w_down"].to(buf.dtype))
    y_d = context.all_reduce(y_d, "sum", mesh, (maxis,))   # the F contraction
    y_all = _combine(y_d, slot, gates, N, k)          # (N, d / D)
    for a in reversed(gather_axes):
        y_all = context.all_gather(y_all, 1, mesh, a)
    if daxes:
        nl = Bl * Sl
        tidx = _combined_axis_index(mesh, daxes)
        y_all = y_all[tidx * nl:(tidx + 1) * nl]
    return y_all.reshape(Bl, Sl, d), aux

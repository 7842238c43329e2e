"""Fake-tensor input stand-ins and their shardings for the dry run
(``repro.launch.specs``).

``input_specs(cfg, shape, mesh, mode)`` gives every input of the step of
``shape.kind`` as fake tensors at the global shape (built on the meta
device by ``Model.init`` and ``init_cache``, then handed to the
``FakeTensorMode`` ``mode``): nothing is allocated, on any device. Beside
each leaf stands its ``sharding.rules.ParamSharding``:

  params       : logical rules (fsdp -> data, tp -> model) with the
                 divisibility fallback (``sharding.rules``)
  token inputs : batch over (pod, data) when divisible, else replicated
  caches/states: batch over (pod, data); for each leaf the largest
                 remaining dim divisible by |model| is sharded over model
                 (KV heads when they divide, else the cache's sequence dim)

``argument_bytes`` sums one rank's shard of every input: the port's
counterpart of the argument bytes of the reference's ``memory_analysis``.
``dtensor_inputs`` wraps each fake input's shard of one rank as a DTensor
with the placements above, for the sharded trace of ``launch.dryrun``.
The ``optimized`` profile serves bf16 params under ``INFERENCE_RULES`` in
the port's served layout (``models.layers``: matmul weights in the
compute dtype, norms, routers and recurrent gates float32).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..models.model import Model
from ..optim import init_opt_state, tree_map
from ..sharding.rules import (INFERENCE_RULES, ParamSharding, local_shape,
                              make_param_shardings, mesh_sizes, norm_axis,
                              param_specs, placements)
from .mesh import mesh_axes

TOKEN_DTYPE = torch.int32       # ids and positions, as the reference's


def _sharding(pspec, mesh) -> ParamSharding:
    pspec = tuple(norm_axis(a) for a in pspec)
    while pspec and pspec[-1] is None:
        pspec = pspec[:-1]
    return ParamSharding(tuple(pspec), placements(tuple(pspec), mesh))


def _batch_axes(mesh, batch: int):
    """The data axes when they divide ``batch``, else None."""
    daxes, _ = mesh_axes(mesh)
    sizes = mesh_sizes(mesh)
    return daxes if daxes and batch % math.prod(sizes[a] for a in daxes) == 0 \
        else None


def _fake(mode, shape, dtype):
    return mode.from_tensor(torch.empty(shape, dtype=dtype, device="meta"))


def token_spec(cfg: ModelConfig, batch: int, seq: int, mesh, mode):
    """(B, K, S) or (B, S) ids as a fake tensor, and their sharding."""
    shape = (batch, cfg.num_codebooks, seq) if cfg.num_codebooks > 1 \
        else (batch, seq)
    return (_fake(mode, shape, TOKEN_DTYPE),
            _sharding((_batch_axes(mesh, batch),), mesh))


def cache_shardings(cache, mesh, batch: int):
    """A ``ParamSharding`` per leaf of the port's per-layer caches (batch
    on axis 0 of every leaf)."""
    daxes, maxis = mesh_axes(mesh)
    sizes = mesh_sizes(mesh)
    msize = sizes[maxis]
    bax = _batch_axes(mesh, batch)

    def one(leaf):
        spec = [None] * leaf.dim()
        spec[0] = bax
        cand = [(leaf.shape[i], i) for i in range(1, leaf.dim())
                if leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize]
        if cand:
            spec[max(cand)[1]] = maxis
        return _sharding(tuple(spec), mesh)

    return tree_map(one, cache)


def _fakes(tree, mode):
    return tree_map(mode.from_tensor, tree)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, mode,
                tc: TrainConfig = None, long_context: bool = False,
                profile: str = "baseline"):
    """{input name: (tree of fake tensors, tree of ``ParamSharding``)} for
    ``shape.kind``: train {"state", "tokens", "labels"} (params in
    ``param_dtype`` with the AdamW state); prefill {"params", "tokens"};
    decode {"params", "tokens" (one id a row), "positions", "cache" of
    ``shape.seq_len`` slots}."""
    model = Model(cfg, device="meta")
    specs = param_specs(cfg)
    B = shape.global_batch
    if shape.kind == "train":
        params = model.init(0, dtype=getattr(torch, cfg.param_dtype))
        opt = init_opt_state(params, getattr(torch, cfg.opt_state_dtype))
        p_shard = make_param_shardings(specs, params, mesh)
        state = {"params": params, "opt": opt}
        shard = {"params": p_shard, "opt": {
            "m": p_shard, "v": p_shard, "step": _sharding((), mesh)}}
        toks = token_spec(cfg, B, shape.seq_len, mesh, mode)
        return {"state": (_fakes(state, mode), shard), "tokens": toks,
                "labels": toks}
    optimized = profile == "optimized"
    params = model.init(0, dtype=torch.bfloat16 if optimized
                        else getattr(torch, cfg.param_dtype))
    p_shard = make_param_shardings(specs, params, mesh,
                                   INFERENCE_RULES if optimized else None)
    out = {"params": (_fakes(params, mode), p_shard)}
    if shape.kind == "prefill":
        out["tokens"] = token_spec(cfg, B, shape.seq_len, mesh, mode)
        return out
    cache = model.init_cache(B, shape.seq_len, long_context=long_context)
    out["cache"] = (_fakes(cache, mode), cache_shardings(cache, mesh, B))
    out["tokens"] = token_spec(cfg, B, 1, mesh, mode)
    out["positions"] = (_fake(mode, (B, 1), TOKEN_DTYPE),
                        _sharding((_batch_axes(mesh, B),), mesh))
    return out


def _pairs(tree, shard):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], shard[k])
    elif isinstance(tree, (list, tuple)):
        for a, b in zip(tree, shard):
            yield from _pairs(a, b)
    else:
        yield tree, shard


def dtensor_inputs(specs, mesh, mode):
    """{input name: tree of DTensors} on the ``DeviceMesh`` ``mesh``: each
    leaf of ``input_specs`` as one rank's fake local shard (its
    ``local_shape`` under the leaf's pspec) with the leaf's placements and
    global shape. Leaves that are one tensor (labels alias tokens) stay
    one DTensor."""
    from torch.distributed.tensor import DTensor
    made = {}

    def wrap(leaf, sh):
        if id(leaf) not in made:
            local = _fake(mode, local_shape(tuple(leaf.shape), sh.pspec, mesh),
                          leaf.dtype)
            made[id(leaf)] = DTensor.from_local(
                local, mesh, sh.placements, run_check=False,
                shape=leaf.shape, stride=leaf.stride())
        return made[id(leaf)]

    def rec(tree, shard):
        if isinstance(tree, dict):
            return {k: rec(tree[k], shard[k]) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rec(a, b) for a, b in zip(tree, shard))
        return wrap(tree, shard)

    return {name: rec(tree, shard) for name, (tree, shard) in specs.items()}


def argument_bytes(specs, mesh) -> int:
    """Bytes of one rank's shard of every input (labels alias tokens in
    the reference's train step but are counted apart, as there)."""
    total = 0
    for tree, shard in specs.values():
        for leaf, sh in _pairs(tree, shard):
            total += math.prod(local_shape(tuple(leaf.shape), sh.pspec, mesh)) \
                * leaf.element_size()
    return total

"""Logical-axis -> mesh-axis translation (``repro.sharding.rules``,
MaxText-style logical sharding).

Every parameter leaf has a logical spec: a tuple with one logical axis name
(or None) per dim. ``param_specs`` gives them for the port's parameter
tree, by block and leaf name, as the reference's ``init_*`` functions
return them beside their params (its stacked leaves carry one more leading
None). ``logical_to_pspec`` maps a spec to mesh axes for a concrete mesh,
as the reference's ``PartitionSpec``, and ``placements`` turns that into
the DTensor placements it implies. The default rules:

  fsdp  -> the data axis (ZeRO-3 parameter sharding)
  tp    -> the model axis (tensor parallelism)

Rules skip axes whose mesh dimension does not divide the array dimension,
so e.g. a 24-head projection on a 16-way model axis degrades to
replicated on that dim instead of failing.

A mesh is a ``torch.distributed.DeviceMesh`` with named dims, or any object
whose ``shape`` maps axis names to sizes (the tests' stand-in).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from .context import mesh_sizes

DEFAULT_RULES = {
    "fsdp": "data",
    "expert_fsdp": "data",     # MoE expert weights
    "tp": "model",
    "batch": ("pod", "data"),
    "cache_seq": "model",
}

# Inference profile: no ZeRO-3 at inference; params are TP-sharded over
# model only and replicated over data (grok's experts stay fsdp-sharded).
INFERENCE_RULES = {
    "fsdp": None,
    "expert_fsdp": "data",
    "tp": "model",
    "batch": ("pod", "data"),
    "cache_seq": "model",
}

_DENSE_IN, _DENSE_OUT, _VEC = ("fsdp", "tp"), ("tp", "fsdp"), (None,)
# block name -> leaf name -> logical spec (the reference's init_* specs)
BLOCK_SPECS = {
    "attn": {"wq": _DENSE_IN, "wk": _DENSE_IN, "wv": _DENSE_IN,
             "wo": _DENSE_OUT, "q_norm": _VEC, "k_norm": _VEC},
    "mlp": {"w_gate": _DENSE_IN, "w_up": _DENSE_IN, "w_down": _DENSE_OUT},
    "moe": {"router": (None, None), "w_gate": (None, "expert_fsdp", "tp"),
            "w_up": (None, "expert_fsdp", "tp"),
            "w_down": (None, "tp", "expert_fsdp")},
    "mamba": {"w_in": _DENSE_IN, "conv_w": (None, "tp"), "conv_b": ("tp",),
              "A_log": _VEC, "dt_bias": _VEC, "D": _VEC, "norm_w": ("tp",),
              "w_out": _DENSE_OUT},
    "mlstm": {"w_up": _DENSE_IN, "w_q": _DENSE_IN, "w_k": _DENSE_IN,
              "w_v": _DENSE_IN, "w_if": (None, None), "b_if": _VEC,
              "norm_w": ("tp",), "w_down": _DENSE_OUT},
    "slstm": {"w_gates": _DENSE_IN, "r_gates": (None, None, None, None),
              "b_gates": _VEC, "norm_w": _VEC, "w_out": _DENSE_IN},
}


class ParamSharding(NamedTuple):
    """A leaf's mesh axes per dim (the reference's ``PartitionSpec``,
    trailing Nones dropped) and the DTensor placements they imply."""
    pspec: Tuple
    placements: Tuple


def _mesh_size(sizes, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def norm_axis(axis):
    """An entry of a pspec as ``PartitionSpec`` holds it: an empty tuple
    is None, a tuple of one axis is that axis."""
    if isinstance(axis, tuple):
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


def logical_to_pspec(spec: Tuple[Optional[str], ...], mesh,
                     shape: Optional[Tuple[int, ...]] = None,
                     rules=None) -> Tuple:
    """Mesh axes of each dim of a leaf with logical ``spec``: a name, a
    tuple of names or None per dim, trailing Nones dropped. An axis absent
    from the mesh, or whose size does not divide the dim, replicates it."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh)
    out = []
    for i, name in enumerate(spec):
        axis = rules.get(name) if name else None
        if isinstance(axis, tuple):
            axis = norm_axis(tuple(a for a in axis if a in sizes))
        elif axis not in sizes:
            axis = None
        if axis is not None and shape is not None:
            if shape[i] % _mesh_size(sizes, axis) != 0:
                axis = None  # non-divisible -> replicate this dim
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(pspec: Tuple, mesh) -> Tuple:
    """The DTensor placements of ``pspec``, one per mesh dim in the mesh's
    order: ``Shard(i)`` where the dim's axis shards tensor dim i, else
    ``Replicate()``. A dim sharded over several axes is split over them in
    mesh order, as a ``PartitionSpec`` of an axis tuple is."""
    owner = {}
    for i, axis in enumerate(pspec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_sizes(mesh))


def local_shape(shape, pspec, mesh) -> Tuple[int, ...]:
    """One rank's shard of a leaf of ``shape`` under ``pspec`` (every split
    divides: ``logical_to_pspec`` replicates the others)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for i, axis in enumerate(pspec):
        if axis is not None:
            out[i] //= _mesh_size(sizes, axis)
    return tuple(out)


def make_param_shardings(specs_tree, params_tree, mesh, rules=None):
    """Mirror the params tree (dicts and lists) with a ``ParamSharding``
    per leaf, divisibility checked against each leaf's shape."""
    def rec(s, p):
        if isinstance(p, dict):
            return {k: rec(s[k], p[k]) for k in p}
        if isinstance(p, list):
            return [rec(a, b) for a, b in zip(s, p)]
        ps = logical_to_pspec(tuple(s), mesh, tuple(p.shape), rules)
        return ParamSharding(ps, placements(ps, mesh))
    return rec(specs_tree, params_tree)


def param_specs(cfg):
    """The logical spec of every leaf ``transformer.init_params`` builds
    for ``cfg``, in a tree of the same structure: a block's leaves by
    ``BLOCK_SPECS``, norms (None,), the embedding (tp, fsdp) and the head
    (fsdp, tp), each with a leading None per codebook axis."""
    from ..models import transformer as tfm   # models import the context
    book = (None,) if cfg.num_codebooks > 1 else ()

    def rec(tree, block=None, name=None):
        if isinstance(tree, dict):
            return {k: rec(v, k if isinstance(v, dict) else block, k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [rec(v) for v in tree]
        if name == "embed":
            return book + ("tp", "fsdp")
        if name == "lm_head":
            return book + ("fsdp", "tp")
        if block is None:
            return _VEC                     # norm1, norm2, final_norm
        return BLOCK_SPECS[block][name]

    return rec(tfm.init_params(None, cfg, "meta"))

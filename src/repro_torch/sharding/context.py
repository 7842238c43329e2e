"""Process-global mesh context (``repro.sharding.context``).

Launch code installs the active mesh here, with the mesh axes that play the
data-parallel and tensor-parallel roles and the sharding profile; model
code that needs explicit collectives (MoE's mesh paths) or a sharding
constraint (the optimized profile's sequence sharding) reads it.
Single-device runs (the tests, the CLIs on one card) leave it unset and the
model takes its local paths. ``mesh`` is a ``torch.distributed.DeviceMesh``
(``launch.mesh``).

``maybe_constraint`` is the counterpart of the reference's
``with_sharding_constraint``: on a DTensor (the dry run's sharded trace) it
redistributes to the placements of the spec; on a plain tensor, or with no
mesh, it is the identity, so the serving and training paths on plain
tensors are unchanged by it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

_MESH = None
_DATA_AXES: Tuple[str, ...] = ()
_MODEL_AXIS: Optional[str] = None
_PROFILE: str = "baseline"       # "baseline" | "optimized"


def set_mesh(mesh, data_axes: Tuple[str, ...] = (),
             model_axis: Optional[str] = None,
             profile: Optional[str] = None) -> None:
    global _MESH, _DATA_AXES, _MODEL_AXIS, _PROFILE
    _MESH, _DATA_AXES, _MODEL_AXIS = mesh, tuple(data_axes), model_axis
    if profile is not None:
        _PROFILE = profile


def set_profile(profile: str) -> None:
    global _PROFILE
    _PROFILE = profile


def profile() -> str:
    return _PROFILE


def optimized() -> bool:
    return _PROFILE == "optimized"


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (imported lazily: importing
    ``torch.distributed.tensor`` costs a second)."""
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def maybe_constraint(x, *spec):
    """Redistribute a DTensor ``x`` to the placements of ``spec`` (one mesh
    axis, tuple of axes or None per leading dim, as a ``PartitionSpec``)
    if a mesh is installed; the identity otherwise and on plain tensors.
    As ``with_sharding_constraint`` constrains the cotangent too, the
    redistribute runs even where ``x`` already has the placements: its
    backward brings the gradient to them."""
    if _MESH is None or not is_dtensor(x):
        return x
    from .rules import norm_axis, placements
    return x.redistribute(_MESH, placements(tuple(norm_axis(a) for a in spec),
                                            _MESH))


def batch_constraint(x):
    """``maybe_constraint`` of an activation (B, ...) to its batch over the
    data axes (where they divide B) and every other dim whole: the layout
    the sharded step starts each block from."""
    if _MESH is None or not is_dtensor(x):
        return x
    sizes = mesh_sizes(_MESH)
    n = math.prod(sizes[a] for a in _DATA_AXES)
    return maybe_constraint(x, _DATA_AXES if x.shape[0] % n == 0 else None)


def tp_layout(t, n=None):
    """A matmul's output (B, ..., N) in a sharded step's layout: the batch
    over the data axes where they divide it, the last dim over the model
    axis where it divides ``n`` (N, or the number of heads N is split
    into next: DTensor cannot split a model-sharded dim into heads it does
    not divide), every other dim whole (a sequence split over the model
    axis would make the next matmul's flattened rows a strided shard,
    which DTensor's ``mm`` rule cannot take). The identity on a plain
    tensor."""
    if _MESH is None or not is_dtensor(t):
        return t
    sizes = mesh_sizes(_MESH)
    b = _DATA_AXES if t.shape[0] % math.prod(
        sizes[a] for a in _DATA_AXES) == 0 else None
    n = t.shape[-1] if n is None else n
    last = _MODEL_AXIS if n % sizes[_MODEL_AXIS] == 0 else None
    return maybe_constraint(t, b, *([None] * (t.dim() - 2)), last)


def batch_local(fn, batched, whole=()):
    """``fn(*batched, *whole)`` run on each rank's local shards where any
    input is a DTensor (the dry run's sharded trace): a batch-parallel
    region, as ``shard_map`` over the data axes. ``batched`` are
    batch-leading tensors, laid out by ``batch_constraint`` (a plain one is
    taken as replicated and split the same way); ``whole`` are used whole
    on every rank (weights, a mask without a batch dim): each rank's
    gradient of one is its rows' part, a partial sum over the mesh dims
    that split the batch. ``fn``'s tensor outputs, all batch-leading, come
    back as DTensors with the batch's placements. With no DTensor input it
    is ``fn`` on the inputs as they are, so plain tensors take the same
    path as without a mesh."""
    if _MESH is None or not any(map(is_dtensor, tuple(batched) + tuple(whole))):
        return fn(*batched, *whole)
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map_only
    rep = [Replicate()] * _MESH.ndim

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, _MESH, rep, run_check=False)

    loc = [batch_constraint(dt(t)) for t in batched]
    place = loc[0].placements
    partial = [Partial() if isinstance(p, Shard) else Replicate()
               for p in place]
    out = fn(*[t.to_local() for t in loc],
             *[maybe_constraint(dt(t)).to_local(grad_placements=partial)
               for t in whole])
    return tree_map_only(torch.Tensor, lambda y: DTensor.from_local(
        y, _MESH, place, run_check=False), out)


@functools.lru_cache(maxsize=None)
def _group(mesh, axes):
    """The process group of the mesh axes ``axes``: one mesh dim's, or the
    flattened dims' of a tuple (a collective over them all, as an XLA
    collective over an axis tuple). Slicing a mesh costs host time, so
    each is made once."""
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[tuple(axes)]._flatten()


def all_gather(t, dim, mesh, axis):
    """``t``'s blocks of the ranks along mesh axis ``axis``, joined on
    ``dim`` (a tiled ``all_gather``), as a functional collective."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return funcol.wait_tensor(gather(t.contiguous(), dim,
                                     _group(mesh, (axis,))))


def all_reduce(t, op, mesh, axes):
    """``t`` reduced by ``op`` ("sum", "max") over the mesh axes ``axes``
    (a psum or pmax), as a functional collective."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op,
                                                _group(mesh, tuple(axes))))


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a stand-in with a dict
    ``shape``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def get_mesh():
    return _MESH


def data_axes() -> Tuple[str, ...]:
    return _DATA_AXES


def model_axis() -> Optional[str]:
    return _MODEL_AXIS


class use_mesh:
    """Context manager installing a mesh for the duration of a block."""

    def __init__(self, mesh, data_axes=(), model_axis=None):
        self._new = (mesh, tuple(data_axes), model_axis)

    def __enter__(self):
        self._old = (_MESH, _DATA_AXES, _MODEL_AXIS)
        set_mesh(*self._new)
        return self._new[0]

    def __exit__(self, *exc):
        set_mesh(*self._old)
        return False

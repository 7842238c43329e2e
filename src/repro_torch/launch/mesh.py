"""Mesh construction (``repro.launch.mesh``): the production meshes of
the dry run, and a named mesh over a real process group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks.

The mesh is a ``DeviceMesh`` over torch's ``fake`` process-group backend:
every rank but 0 is imaginary and no collective moves data, which is what a
dry run on one host needs. Installing a process group is a process-wide
side effect (the reference's counterpart is its ``XLA_FLAGS`` device
count), so only the dry run's own process calls ``make_production_mesh``;
importing this module touches nothing.

``make_mesh`` names a ``DeviceMesh`` of any shape over the process group a
caller has installed (``torch.distributed.init_process_group`` with its
address, world size and rank given: gloo on the CPU, NCCL on the card),
for the MoE mesh paths and the sharding constraints that read it from
``sharding.context``.
"""
from __future__ import annotations

import torch.distributed as dist

from ..sharding.rules import mesh_sizes


def _fake_store():
    """The fake backend's store. ``FakeStore`` lives in
    ``torch.testing._internal.distributed.fake_pg`` (importing it registers
    the ``fake`` backend), a private module: fail loudly without it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), which "
            f"this torch {__import__('torch').__version__} lacks") from e
    return FakeStore()


def make_production_mesh(*, multi_pod: bool = False):
    """A ``DeviceMesh`` of the reference's production shape and axis names
    over the fake backend (rank 0 of 256 or 512). Installs the process
    group if none is; refuses one of another world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=n,
                                store=_fake_store())
    elif dist.get_world_size() != n:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is installed; the mesh needs {n}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with the axis names ``axes`` over the
    installed process group, whose world size must be the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("install a process group first "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is installed; the mesh needs {n}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_axes(mesh):
    """-> (batch/data axes tuple, model axis name) of a ``DeviceMesh`` or a
    stand-in (``sharding.rules.mesh_sizes``)."""
    names = mesh_sizes(mesh)
    data = tuple(a for a in names if a in ("pod", "data"))
    return data, "model"

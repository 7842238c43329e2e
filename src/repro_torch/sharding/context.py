"""Process-global mesh context (``repro.sharding.context``).

Launch code installs the active mesh here, with the mesh axes that play the
data-parallel and tensor-parallel roles and the sharding profile; code that
reads a mesh asks here. Single-device runs (the tests, the CLIs on one
card) leave it unset. ``mesh`` is a ``torch.distributed.DeviceMesh``
(``launch.mesh``).

The reference's ``maybe_constraint`` (a sharding constraint inside a
traced step) has no counterpart yet: the port traces its steps unsharded
(ROADMAP §1 item 6b).
"""
from __future__ import annotations

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


def profile() -> str:
    return _PROFILE


def optimized() -> bool:
    return _PROFILE == "optimized"


def get_mesh():
    return _MESH


def data_axes() -> Tuple[str, ...]:
    return _DATA_AXES


def model_axis() -> Optional[str]:
    return _MODEL_AXIS


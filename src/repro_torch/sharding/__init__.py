"""Logical sharding of the port (``repro.sharding``): the rules that map a
leaf's logical axes to mesh axes, and the process-wide mesh context."""
from . import context, rules  # noqa: F401
from .context import data_axes, get_mesh, model_axis, set_mesh  # noqa: F401
from .rules import (logical_to_pspec, make_param_shardings,  # noqa: F401
                    param_specs)

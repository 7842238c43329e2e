"""What a kernel wrapper launches for one problem shape: the kernel
instances with their grids, blocks and clusters, how the work is split
across blocks, and the buffers the wrapper allocates.

Each wrapper (``tree_attention``, ``flash_decode``, ``quant_matmul``,
``distill_loss``) builds its ``LaunchPlan`` from shapes alone, allocates
its outputs and scratch from ``buffers`` and launches with ``chunk`` and
``splits``. ``analysis.kernel_lint`` reads the same plans, so what it
checks (grids, splits, buffer dtypes, row bytes) is what the wrappers do,
and asks the card for each instance's registers and shared memory through
the library's query entry, which picks the instance as the launcher does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

#: the C types' names in the kernels' template arguments, as c++filt
#: prints them
CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}


@dataclass(frozen=True)
class Launch:
    """One kernel launch: the instance (as c++filt prints it, without its
    namespace and parameters), its grid, threads a block and blocks a
    cluster (1: no cluster)."""

    symbol: str
    grid: Tuple[int, int, int]
    threads: int
    cluster: int = 1


@dataclass(frozen=True)
class LaunchPlan:
    """A wrapper's launches for one shape. ``extent`` (slots or K rows) is
    split into ``splits`` pieces of ``chunk``, a multiple of ``step``, one
    per block along the split axis. ``buffers`` are (name, shape, dtype)
    the wrapper allocates, ``rows`` (operand, bytes of one row) it reads,
    and ``query`` the arguments of ``<library>_query`` that pick the same
    instances (``analysis.kernel_lint``)."""

    kernel: str
    library: str
    launches: Tuple[Launch, ...]
    query: Tuple[int, ...]
    extent: int
    chunk: int
    splits: int = 1
    step: int = 1
    buffers: Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...] = ()
    rows: Tuple[Tuple[str, int], ...] = ()

    def allocate(self, device) -> Dict[str, torch.Tensor]:
        """The buffers, uninitialised, on ``device``."""
        return {name: torch.empty(shape, dtype=dtype, device=device)
                for name, shape, dtype in self.buffers}

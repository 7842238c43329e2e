"""Public wrappers over the port's kernels (``repro.kernels.ops``).

Each wrapper runs the kernel's plain version for tensors that lie on the
CPU, and for CUDA tensors launches the kernel or raises: nothing on the
card falls back to the plain version. ``LAUNCHES`` counts, per kernel,
the launches made through these wrappers, so that a run can show that its
path went through the kernels.
"""
from __future__ import annotations

from . import ref
from . import tree_attention as tk

LAUNCHES = {"tree_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tree_verify_attention(q, k, v, mask, softcap=None):
    """q (B, Hkv, N, G, hd), k/v (B, S, Hkv, hd), mask (B, N, S) -> fp32
    (B, Hkv, N, G, hd): every node of a speculative draft tree scored in
    one kernel launch (oracle: ``ref.ref_tree_attention``)."""
    if q.device.type == "cpu":
        return ref.ref_tree_attention(q, k, v, mask, softcap)
    out = tk.tree_attention(q, k, v, mask, softcap)
    LAUNCHES["tree_attention"] += 1
    return out

"""Parameters of the reference, as numpy arrays, into the port's layout.

The reference keeps its decoder parameters stacked: ``params["groups"]``
holds one dict per layer kind of the repeating pattern, each leaf with a
leading axis over the n repetitions, and ``params["rem"]`` the remainder
layers. The port keeps one dict per layer in ``params["layers"]``.

The input is the reference's pytree mapped to numpy
(``jax.tree.map(np.asarray, params)``), or the flat dict of a
``repro/checkpoint/io.py`` ``.npz`` file, whose keys are key paths such as
``['groups'][0]['attn']['wq']``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .configs.base import ModelConfig

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_NORMS = ("norm1", "norm2", "final_norm")


def _unflatten(flat):
    """{"['a'][0]['b']": arr} -> {"a": {0: {"b": arr}}}."""
    tree = {}
    for path, arr in flat.items():
        keys = [name if name else int(idx) for name, idx in _KEY.findall(path)]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return tree


def _convert(tree, device, dtype, name=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32 if name in _NORMS else dtype)


def params_from_jax(np_tree, cfg: ModelConfig, device):
    """The port's parameters from the reference's (numpy) parameters.

    Layer i of the repeating pattern's k-th kind in repetition r is
    ``groups[k][name][r]``; layers follow in order r-major, then ``rem``.
    Matmul weights are cast to ``cfg``'s compute dtype, norms stay float32.
    """
    if any(isinstance(k, str) and k.startswith("[") for k in np_tree):
        np_tree = _unflatten(np_tree)
    g, n, rem = cfg.pattern_blocks()
    groups = np_tree.get("groups") or {}
    rems = np_tree.get("rem") or {}
    if isinstance(groups, dict):          # unflattened: {0: ..., 1: ...}
        groups = [groups[k] for k in sorted(groups)]
    if isinstance(rems, dict):
        rems = [rems[k] for k in sorted(rems)]
    stacked = {np.shape(leaf)[0] for grp in groups for leaf in _leaves(grp)}
    if len(groups) != len(g) or stacked - {n} or len(rems) != len(rem):
        raise ValueError(f"{cfg.name}: the tree holds {len(groups)} groups "
                         f"stacked {sorted(stacked)} deep and {len(rems)} "
                         f"remainder layers; the config has {len(g)} stacked "
                         f"{n} deep and {len(rem)}")
    layers = [_slice(groups[k], r) for r in range(n) for k in range(len(g))]
    layers.extend(rems)
    out = {k: v for k, v in np_tree.items() if k not in ("groups", "rem")}
    out["layers"] = layers
    return _convert(out, torch.device(device), cfg.compute_dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _slice(tree, r):
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]

"""Parameters of the reference, as numpy arrays, into the port's layout.

The reference keeps its decoder parameters stacked: ``params["groups"]``
holds one dict per layer kind of the repeating pattern, each leaf with a
leading axis over the n repetitions, and ``params["rem"]`` the remainder
layers. The port keeps one dict per layer in ``params["layers"]``.

The input is the reference's pytree mapped to numpy
(``jax.tree.map(np.asarray, params)``), or the flat dict of a
``repro/checkpoint/io.py`` ``.npz`` file, whose keys are key paths such as
``['groups'][0]['attn']['wq']``.

Quantized parameters come across too. In a pytree they are the reference's
``QWeight`` nodes (arrays ``q``, ``scale``, optional ``pre``; ``bits`` and
``group`` beside them); in a ``save``/``save_quantized`` file a quantized
leaf is three keys ending in ``.q``, ``.scale`` and ``.pre``, and
``save_quantized`` adds a ``__quant_meta__`` entry with each one's (bits,
group, has pre). They become the port's ``quant.QWeight``, with ``q`` kept
int8 (int8 layout) or uint8 (packed int4) and the scales in float32.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from .configs.base import ModelConfig
from .quant.qweight import QWeight

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")
_NORMS = ("norm1", "norm2", "final_norm")
_META_KEY = "__quant_meta__"
_QFIELDS = ("q", "scale", "pre")


def _layout(q, scale):
    """(bits, group) of a quantized leaf from its arrays: int8 q is the
    per-column int8 layout; uint8 q packs two K rows a byte (int4), whose
    group is K over the scale's rows. Stacked leaves carry a leading axis."""
    if q.dtype == np.int8:
        return 8, 0
    if q.dtype == np.uint8:
        return 4, 2 * q.shape[-2] // scale.shape[-2]
    raise ValueError(f"a quantized leaf has q of dtype {q.dtype}")


def _unflatten(flat):
    """{"['a'][0]['b']": arr} -> {"a": {0: {"b": arr}}}; the ``.q``,
    ``.scale`` and ``.pre`` parts of one quantized leaf become one
    ``QWeight`` of numpy arrays, its layout checked against the file's
    ``__quant_meta__`` where there is one."""
    flat = dict(flat)
    meta = flat.pop(_META_KEY, None)
    meta = json.loads(str(meta)) if meta is not None else None
    tree, qnodes = {}, {}
    for path, arr in flat.items():
        parts = _KEY.findall(path)
        if parts and parts[-1][2] in _QFIELDS:
            qnodes.setdefault(path[:path.rindex(".")], {})[parts[-1][2]] = arr
            continue
        _insert(tree, parts, np.asarray(arr))
    for path, f in qnodes.items():
        q, scale, pre = (None if f.get(a) is None else np.asarray(f[a])
                         for a in _QFIELDS)
        bits, group = _layout(q, scale)
        held = [bits, group, pre is not None]
        if meta is not None and meta.get(path) != held:
            raise ValueError(f"{path}: the arrays hold (bits, group, has pre) "
                             f"{held}; the file's meta says {meta.get(path)}")
        _insert(tree, _KEY.findall(path),
                QWeight(q=q, scale=scale, pre=pre, bits=bits, group=group))
    return tree


def _insert(tree, parts, leaf):
    keys = [name if name else int(idx) for name, idx, _ in parts]
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def _is_qnode(node) -> bool:
    """A quantized leaf: the port's QWeight or the reference's QWeight node
    (duck-typed: the port imports nothing of the reference)."""
    return all(hasattr(node, a) for a in ("q", "scale", "pre", "bits", "group"))


def _convert(tree, device, dtype, name=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device, dtype) for v in tree]
    if _is_qnode(tree):
        def f32(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        return QWeight(q=torch.from_numpy(np.array(tree.q)).to(device),
                       scale=f32(tree.scale),
                       pre=None if tree.pre is None else f32(tree.pre),
                       bits=int(tree.bits), group=int(tree.group))
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32 if name in _NORMS else dtype)


def params_from_jax(np_tree, cfg: ModelConfig, device, dtype=None):
    """The port's parameters from the reference's (numpy) parameters.

    Layer i of the repeating pattern's k-th kind in repetition r is
    ``groups[k][name][r]``; layers follow in order r-major, then ``rem``.
    Matmul weights are cast to ``dtype``: by default ``cfg``'s compute
    dtype, as a served model holds them; a model to be trained passes its
    ``param_dtype``. Norms stay float32, and quantized weights keep their
    integer ``q`` and float32 scales.
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
    return _convert(out, torch.device(device), dtype or cfg.compute_dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if _is_qnode(tree):
        return [tree.q]
    return [tree]


def _slice(tree, r):
    """Layer r of a stacked subtree; a stacked QWeight's q, scale and pre
    are sliced like every other leaf."""
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    if _is_qnode(tree):
        return QWeight(q=np.asarray(tree.q)[r], scale=np.asarray(tree.scale)[r],
                       pre=None if tree.pre is None else np.asarray(tree.pre)[r],
                       bits=tree.bits, group=tree.group)
    return np.asarray(tree)[r]

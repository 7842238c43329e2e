"""Parameter trees to ``.npz`` and back (``repro.checkpoint.io``), in the
port's own layout: one entry per leaf, keyed by its path as the reference
writes key paths (``['layers'][0]['attn']['wq']``). numpy has no bf16, so
bf16 tensors are stored as float32 and cast back on load.

A ``QWeight`` is stored as three entries, ``<path>.q``, ``<path>.scale``
and ``<path>.pre`` (the last only when it has an AWQ pre-scale), as the
reference flattens its ``QWeight`` nodes. ``save_quantized`` and
``load_quantized`` also record and verify each quantized leaf's (bits,
group): loading an int4 file into an int8 template raises instead of
reinterpreting bytes, and the AWQ ``pre`` is taken from the file whether
or not the template has one.

A file written by the reference (stacked layer groups) is read by
``bridge.params_from_jax(dict(np.load(path)), cfg, device)``.

``save_draft_heads`` writes head parameters beside a ``__drafthead_meta__``
entry holding the whole ``HeadConfig``, as the reference does; both
packages write the same keys, so either package's ``load_draft_heads``
reads the other's file, and a config that differs from the loading
drafter's raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ..quant.calib import named_leaves
from ..quant.qweight import QWeight

_META_KEY = "__quant_meta__"
_HEAD_META_KEY = "__drafthead_meta__"


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in named_leaves(tree):
        if isinstance(leaf, QWeight):
            flat[path + ".q"] = _np(leaf.q)
            flat[path + ".scale"] = _np(leaf.scale)
            if leaf.pre is not None:
                flat[path + ".pre"] = _np(leaf.pre)
        else:
            flat[path] = _np(leaf)
    return flat


def _write(path: str, flat: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def save(path: str, tree: Any) -> None:
    _write(path, _flatten(tree))


def _restore(arr, like: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{name}: {tuple(arr.shape)} != {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes, dtypes and devices
    preserved)."""
    with np.load(path) as data:
        return _load_into(data, like, "")


def _load_into(data, like, path):
    if isinstance(like, dict):
        return {k: _load_into(data, v, f"{path}['{k}']") for k, v in like.items()}
    if isinstance(like, list):
        return [_load_into(data, v, f"{path}[{i}]") for i, v in enumerate(like)]
    if isinstance(like, QWeight):
        pre = None
        if like.pre is not None:
            pre = _restore(data[path + ".pre"], like.pre, path + ".pre")
        return QWeight(q=_restore(data[path + ".q"], like.q, path + ".q"),
                       scale=_restore(data[path + ".scale"], like.scale,
                                      path + ".scale"),
                       pre=pre, bits=like.bits, group=like.group)
    return _restore(data[path], like, path)


# ------------------------------------------------------ quantized checkpoints

def _quant_meta(tree) -> dict:
    """{path of a QWeight: [bits, group, has_pre]} over the tree."""
    return {p: [n.bits, n.group, n.pre is not None]
            for p, n in named_leaves(tree) if isinstance(n, QWeight)}


def save_quantized(path: str, tree: Any) -> None:
    """``save`` plus a meta entry with each QWeight's (bits, group, has AWQ
    pre-scale): the layout that the arrays alone do not pin down."""
    flat = _flatten(tree)
    flat[_META_KEY] = np.asarray(json.dumps(_quant_meta(tree)))
    _write(path, flat)


def _reconcile_pre(like, data, stored: dict, path=""):
    """Make each template QWeight's ``pre`` match the file: a template built
    without calibration data has none, and loading without the file's
    ``pre`` would compute ``x @ (s * W)`` without the compensating 1/s."""
    if isinstance(like, dict):
        return {k: _reconcile_pre(v, data, stored, f"{path}['{k}']")
                for k, v in like.items()}
    if isinstance(like, list):
        return [_reconcile_pre(v, data, stored, f"{path}[{i}]")
                for i, v in enumerate(like)]
    if not isinstance(like, QWeight):
        return like
    has_pre = bool(stored[path][2])
    pre = like.pre
    if has_pre and pre is None:
        pre = torch.zeros(data[path + ".pre"].shape, dtype=torch.float32,
                          device=like.q.device)
    elif not has_pre:
        pre = None
    return QWeight(q=like.q, scale=like.scale, pre=pre, bits=like.bits,
                   group=like.group)


def load_quantized(path: str, like: Any) -> Any:
    """``load`` that also verifies the stored (bits, group) of every
    quantized leaf against ``like``'s and takes the AWQ pre-scale from the
    file."""
    with np.load(path) as data:
        if _META_KEY in data:
            stored = json.loads(str(data[_META_KEY]))
            want = _quant_meta(like)
            if ({k: v[:2] for k, v in stored.items()}
                    != {k: v[:2] for k, v in want.items()}):
                raise ValueError(f"quantized layout mismatch: file {stored} vs "
                                 f"template {want}")
            like = _reconcile_pre(like, data, stored)
        return _load_into(data, like, "")


# ------------------------------------------------------ draft-head checkpoints

def save_draft_heads(path: str, drafter, head_params) -> None:
    """Head parameters plus the ``HeadConfig`` they belong to: heads reuse
    their target's embedding and LM head and read its hidden states, so
    the file pins kind, widths and head counts."""
    flat = _flatten(head_params)
    flat[_HEAD_META_KEY] = np.asarray(json.dumps(dataclasses.asdict(drafter.hc)))
    _write(path, flat)


def load_draft_heads(path: str, drafter, device="cuda", dtype=None) -> Any:
    """Head parameters for ``drafter`` (a ``draftheads.HeadDrafter``) from a
    file of either package, on ``device``: matmul weights in ``dtype`` (by
    default the config's float32), norms in float32. Raises if the stored
    config differs from the drafter's, or a shape from the config's."""
    from ..bridge import head_params_from_jax
    from ..models.model import resolve_device
    with np.load(path) as data:
        flat = dict(data)
    if _HEAD_META_KEY in flat:
        stored = json.loads(str(flat.pop(_HEAD_META_KEY)))
        want = dataclasses.asdict(drafter.hc)
        if stored != want:
            raise ValueError(f"draft-head config mismatch: file {stored} vs "
                             f"drafter {want}")
    return head_params_from_jax(flat, drafter.hc, resolve_device(device), dtype)

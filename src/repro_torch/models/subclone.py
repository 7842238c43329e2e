"""Weight subcloning (paper 2.1, citing Samragh et al. 2023;
``repro.models.subclone``): initialise the drafter from the target by
(a) picking uniformly spaced layers and (b) truncating every weight tensor
to the drafter's dimensions (a leading slice along each axis).

Requirements: the same family (layer pattern) and the same vocabulary,
the ``cfg.drafter()`` pairing. The port keeps one parameter dict per layer,
so the reference's choice of stacked groups is a choice of layers here:
``np.linspace(0, n_t - 1, n_d).round()``, the reference's indices.
"""
from __future__ import annotations

import numpy as np
import torch


def _slice_to(t, like: torch.Tensor) -> torch.Tensor:
    """The leading slice of ``t`` in ``like``'s shape, in ``like``'s dtype
    and on its device."""
    out = t[tuple(slice(0, s) for s in like.shape)]
    assert out.shape == like.shape, (tuple(t.shape), tuple(like.shape))
    return out.to(device=like.device, dtype=like.dtype).clone()


def _clone(d_tree, t_tree):
    if isinstance(d_tree, dict):
        return {k: _clone(v, t_tree[k]) for k, v in d_tree.items()}
    return _slice_to(t_tree, d_tree)


def subclone(t_params, t_cfg, d_params_init, d_cfg):
    """-> drafter params initialised from the target.

    t_params: trained target params; d_params_init: randomly initialised
    drafter params, which give the exact shapes and dtypes."""
    assert t_cfg.layer_pattern == d_cfg.layer_pattern, "same family required"
    assert t_cfg.vocab_size == d_cfg.vocab_size, "shared tokenizer required"
    n_t, n_d = len(t_params["layers"]), len(d_params_init["layers"])
    sel = np.linspace(0, n_t - 1, n_d).round().astype(int)
    out = {k: _clone(v, t_params[k]) for k, v in d_params_init.items()
           if k != "layers"}
    out["layers"] = [_clone(d_layer, t_params["layers"][i])
                     for d_layer, i in zip(d_params_init["layers"], sel)]
    return out

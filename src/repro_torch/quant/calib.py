"""AWQ-lite calibration and whole-model post-training quantization
(``repro.quant.calib``).

Calibration needs the input activations of every matmul. The port keeps
one parameter dict per layer and runs its layers in a Python loop, so the
calibration forward is the model's own training forward
(``backbone(mode="train")`` and the lm head, under ``torch.no_grad()``)
with a capture hook installed in ``models.layers.matmul_param``; it scales
the embeddings of a ``scale_embed`` config (Gemma-2) and windows the
local layers, as the reference's calibration forward does. The hook
records the per-input-channel absmax of every activation, keyed by the
identity of the weight tensor it met; identities are then resolved to key
paths of the parameter tree (``['layers'][0]['attn']['wq']``), the names
under which the port's checkpoints store the leaves.

Calibration batches come from the distillation datagen pipeline
(``core.datagen.generate_distillation_dataset``): responses of the target
are the token distribution the drafter serves under.

Only 2-D matmul weights with the canonical names (QKV and output
projections, SwiGLU, lm head) are quantized; embeddings, norms, and an
MoE layer's router and (E, K, N) expert banks stay full precision, as in
the reference. The calibration forward runs the MoE blocks; their expert
matmuls do not pass through ``matmul_param``, so they record nothing. It
runs the recurrent blocks too; a Mamba block's projections (``w_in``,
``w_out``) are not quantized. zamba2's shared attention sets
(``params["shared_attn"]``) are quantized per set with plain absmax and
no AWQ pre-scale, even with AWQ on, as the reference quantizes its
stacked sets. An mLSTM block holds ``w_up`` and ``w_down``, names the
reference quantizes and then cannot read (ROADMAP §3 item 9):
``quantize_params`` refuses a config with mLSTM layers.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import MLSTM, QuantConfig
from ..models import layers as layers_mod
from ..models.layers import FLOAT32_LEAVES
from ..models import transformer as tfm
from .qweight import QWeight, quantize_weight

#: the refusal of a config with mLSTM layers (ROADMAP.md §3 item 9)
MLSTM_REFUSAL = ("weight quantization of mLSTM layers is refused: the "
                 "reference quantizes their w_up and w_down and then cannot "
                 "read them (ROADMAP §3 item 9)")

#: weight leaves eligible for quantization (2-D matmul weights only)
QUANT_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                      "lm_head")


class ActCapture:
    """Accumulates per-input-channel activation absmax (on the activation's
    device), keyed by id(weight)."""

    def __init__(self):
        self.stats: Dict[int, torch.Tensor] = {}

    def record(self, w, x):
        a = x.detach().float().abs().reshape(-1, x.shape[-1]).amax(dim=0)
        k = id(w)
        self.stats[k] = torch.maximum(self.stats[k], a) if k in self.stats else a


@contextmanager
def capture_activations():
    cap = ActCapture()
    layers_mod._ACT_CAPTURE = cap
    try:
        yield cap
    finally:
        layers_mod._ACT_CAPTURE = None


def named_leaves(tree, prefix: str = ""):
    """(key path, leaf) of every tensor or ``QWeight`` of a parameter tree,
    paths written as the reference writes them: ``['layers'][0]['attn']``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _calib_forward(params, tokens, cfg):
    """The training forward plus the lm head, which records its input."""
    hidden, _ = tfm.backbone(params, tokens, cfg, mode="train")
    tfm.logits_from_hidden(params, hidden, cfg)


def collect_act_stats(params, cfg, calib_tokens,
                      batch_size: int = 8) -> Dict[str, np.ndarray]:
    """Run calibration batches, return {key path: act_amax (K,) float32}."""
    toks = np.asarray(calib_tokens)
    dev = next(t for _, t in named_leaves(params)
               if isinstance(t, torch.Tensor)).device
    with torch.no_grad(), capture_activations() as cap:
        for i in range(0, toks.shape[0], batch_size):
            batch = torch.as_tensor(toks[i:i + batch_size], dtype=torch.long,
                                    device=dev)
            _calib_forward(params, batch, cfg)
    by_id = {id(leaf): path for path, leaf in named_leaves(params)}
    return {by_id[k]: v.cpu().numpy() for k, v in cap.stats.items()
            if k in by_id}


def _fit_group(K: int, group: int) -> int:
    """Largest even group <= ``group`` dividing K (0 if none: skip int4)."""
    g = min(group, K)
    g -= g % 2
    while g >= 2 and K % g:
        g -= 2
    return max(g, 0)


def _is_quant_target(name, leaf) -> bool:
    return (name in QUANT_WEIGHT_NAMES and isinstance(leaf, torch.Tensor)
            and leaf.dim() == 2)


def quantize_params(model, params, qcfg: QuantConfig,
                    calib_tokens: Optional[np.ndarray] = None,
                    stats: Optional[Dict[str, np.ndarray]] = None):
    """Post-training quantization of a parameter tree, leaf by leaf on the
    leaves' device.

    With ``calib_tokens`` (N, S) int (e.g. datagen output) an AWQ-lite
    calibration pass supplies per-input-channel activation stats; ``stats``
    hands in stats computed elsewhere instead. Without either, plain
    per-channel (int8) / per-group (int4) absmax quantization. Returns a new
    tree with ``QWeight``s in place of the quantized matmul weights; the
    other leaves are the input's own tensors."""
    bits = qcfg.bits
    if bits == 0:                       # weights=None: nothing to quantize
        return params
    if MLSTM in model.cfg.layer_pattern:
        raise ValueError(f"{model.cfg.name}: {MLSTM_REFUSAL}")
    if stats is None:
        stats = {}
        if calib_tokens is not None and qcfg.awq:
            stats = collect_act_stats(params, model.cfg, calib_tokens)

    def walk(tree, path, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}['{k}']", k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(tree)]
        if not _is_quant_target(name, tree):
            return tree
        b, group = bits, 0
        if bits == 4:
            group = _fit_group(tree.shape[0], qcfg.group_size)
            if group == 0:
                b = 8                             # odd in-dim: fall back
        shared = path.startswith("['shared_attn']")      # plain absmax
        return quantize_weight(tree, bits=b, group=group,
                               act_amax=None if shared else stats.get(path),
                               awq_alpha=qcfg.awq_alpha)

    return walk(params, "")


def cast_unquantized(params, dtype):
    """Cast the floating leaves that are neither ``QWeight``s nor norm
    weights nor ``models.layers.FLOAT32_LEAVES`` (the embedding, expert
    banks, and any matmul weight left in float32) to ``dtype``, in a new
    tree: a model quantized from float32 weights then holds what a served
    model holds. Norm weights, routers and the recurrent blocks' gates,
    convs and biases stay float32."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if (isinstance(tree, QWeight) or "norm" in (name or "")
                or name in FLOAT32_LEAVES or not tree.is_floating_point()):
            return tree
        return tree.to(dtype)

    return walk(params)

"""Phase-3 distillation fine-tuning (paper §2.3): white-box KD with the
target model in the loop (``repro.training.finetune``).

Per batch the frozen target runs a forward pass (no gradient) that gives its
full output distribution, and the drafter is optimised with the configured
distillation loss (kld / tvd / tvdpp / ...). Batches are drawn 9:1 from the
distillation and pretraining datasets (``data.mixing``). Vocabularies above
``CHUNKED_VOCAB_THRESHOLD`` go through ``chunked_distill_loss``, which
never holds both models' (B, S, V) logits; smaller ones take the direct
route.

``use_kernels`` is the reference's ``use_pallas``: kld, tvd and tvdpp send
their vocabulary reduction through the distill-loss kernels
(``kernels.ops``); kld_bwd and jsd stay plain. The reference honours the
flag only on the direct route; the port honours it on the chunked route too
(``chunked_distill_loss``), with the same value and gradient, so that
Llama-2's 32000-token vocabulary runs the kernels.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..core.losses import KERNEL_KINDS, chunked_distill_loss, distill_loss
from ..kernels import ops
from ..models import transformer as tfm
from ..models.model import Model
from ..optim import adamw_update
from .pretrain import log_metrics, value_and_grad

CHUNKED_VOCAB_THRESHOLD = 8192


def distill_loss_and_grads(draft: Model, target: Model, params, t_params,
                           tokens, mask, loss_kind: str = "tvdpp",
                           use_kernels: bool = False):
    """(loss, gradients of the drafter's ``params``) for one batch."""
    with torch.no_grad():
        t_hidden = target.hidden(t_params, tokens)
    kernels = use_kernels and loss_kind in KERNEL_KINDS

    def loss_fn(p):
        s_hidden = draft.hidden(p, tokens)
        if draft.cfg.vocab_size > CHUNKED_VOCAB_THRESHOLD:
            return chunked_distill_loss(loss_kind, p, t_params, s_hidden,
                                        t_hidden, mask, draft.cfg, target.cfg,
                                        use_kernels=kernels)
        s_logits = tfm.logits_from_hidden(p, s_hidden, draft.cfg)
        with torch.no_grad():
            t_logits = tfm.logits_from_hidden(t_params, t_hidden, target.cfg)
        if kernels:
            V = s_logits.shape[-1]
            return ops.fused_distill_loss(loss_kind, s_logits.reshape(-1, V),
                                          t_logits.reshape(-1, V),
                                          mask.reshape(-1))
        return distill_loss(loss_kind, s_logits, t_logits, mask)

    return value_and_grad(loss_fn, params)


def make_distill_step(draft: Model, target: Model, tc: TrainConfig,
                      loss_kind: str = "tvdpp", use_kernels: bool = False):
    def step(state, t_params, tokens, mask):
        loss, grads = distill_loss_and_grads(draft, target, state["params"],
                                             t_params, tokens, mask,
                                             loss_kind, use_kernels)
        new_params, new_opt, info = adamw_update(state["params"], grads,
                                                 state["opt"], tc)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, "distill_loss": loss, **info})
    return step


def finetune(draft: Model, target: Model, state, t_params,
             batches: Iterator[np.ndarray], tc: TrainConfig, steps: int,
             loss_kind: str = "tvdpp", log_every: int = 0, callback=None,
             use_kernels: bool = False):
    """Host loop over (B, S) token batches, every position counted."""
    step_fn = make_distill_step(draft, target, tc, loss_kind, use_kernels)
    history = []
    for i in range(steps):
        chunk = torch.as_tensor(next(batches), dtype=torch.long,
                                device=draft.device)
        if chunk.dim() != 2:
            raise ValueError("only single-codebook (B, S) batches are ported")
        mask = torch.ones(chunk.shape, dtype=torch.float32, device=draft.device)
        state, metrics = step_fn(state, t_params, chunk, mask)
        log_metrics(history, i, metrics, log_every, callback)
    return state, history

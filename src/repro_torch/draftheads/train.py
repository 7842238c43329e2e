"""Head distillation against live target activations
(``repro.draftheads.train``).

One target forward per batch, under ``torch.no_grad()`` and
``models.model.capture_hidden``, gives both the teacher logits and the
teacher features the heads read; the heads are then trained
teacher-forced with the distillation losses of ``core.losses``
(kld / tvd / tvdpp / ...):

  eagle   x_i = fuse(h_i, t_{i+1}) for i = 0..S-2, one causal block pass over
          the whole sequence (training treats it as one long round; serving
          rounds restart the in-round window every round, the usual EAGLE
          approximation). Head logits at slot i predict token i+2, teacher
          slot i+1. An L2 term weighted ``EAGLE_FEAT_WEIGHT`` pulls the
          block output toward the target's next feature h_{i+1}.
  medusa  head k reads h_i and predicts token i+1+k, teacher slot i+k; the
          loss is the mean over the K heads.

As in the reference, the loss is the unchunked ``core.losses.distill_loss``
(not the fused distill-loss kernels), the gradient is taken over the head
parameters only, and the update is ``optim.adamw``'s.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..core.losses import distill_loss
from ..models.model import Model, capture_hidden
from ..optim import adamw_update, init_opt_state
from ..training.pretrain import log_metrics, value_and_grad
from .drafter import HeadDrafter
from .heads import eagle_block, eagle_fuse, eagle_logits, medusa_logits

EAGLE_FEAT_WEIGHT = 0.1     # weight of the feature-regression term


def make_head_train_state(drafter: HeadDrafter, seed: int, device="cuda"):
    """Seeded float32 master head weights and a zeroed AdamW state."""
    params = drafter.init(seed, device)
    return {"params": params, "opt": init_opt_state(params)}


def _eagle_losses(hp, drafter, t_params, t_cfg, loss_kind, tokens, h,
                  t_logits, mask):
    hc = drafter.hc
    x = eagle_fuse(hp, t_params, h[:, :-1], tokens[:, 1:])
    B, T, _ = x.shape
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    g = eagle_block(hp, hc, x, x.new_zeros((B, 0, hc.d_model)),
                    causal[None].expand(B, T, T))
    s_logits = eagle_logits(hp, t_params, t_cfg, hc, g)
    dl = distill_loss(loss_kind, s_logits, t_logits[:, 1:], mask[:, 1:])
    m = mask[:, 1:, None]
    feat_l2 = ((g - h[:, 1:]).float().square() * m).sum() \
        / (m.sum() * hc.d_model).clamp(min=1.0)
    return dl, feat_l2


def _medusa_loss(hp, drafter, t_params, t_cfg, loss_kind, h, t_logits, mask):
    hc = drafter.hc
    S = h.shape[1]
    s_all = medusa_logits(hp, t_params, t_cfg, hc, h)           # (B, S, K, V)
    total = 0.0
    for j in range(min(hc.num_medusa_heads, S - 1)):
        off = j + 1
        total = total + distill_loss(loss_kind, s_all[:, :S - off, j],
                                     t_logits[:, off:], mask[:, off:])
    return total / hc.num_medusa_heads


def make_head_distill_step(drafter: HeadDrafter, target: Model,
                           tc: TrainConfig, loss_kind: str = "tvdpp"):
    def step(state, t_params, tokens, mask):
        with torch.no_grad(), capture_hidden() as box:
            t_logits = target.logits(t_params, tokens)
        h = box["hidden"]
        parts = {}

        def loss_fn(hp):
            if drafter.kind == "eagle":
                dl, feat_l2 = _eagle_losses(hp, drafter, t_params, target.cfg,
                                            loss_kind, tokens, h, t_logits,
                                            mask)
                total = dl + EAGLE_FEAT_WEIGHT * feat_l2
            else:
                dl = _medusa_loss(hp, drafter, t_params, target.cfg,
                                  loss_kind, h, t_logits, mask)
                feat_l2, total = torch.zeros((), device=h.device), dl
            parts.update(distill_loss=dl.detach(), feat_l2=feat_l2.detach())
            return total

        loss, grads = value_and_grad(loss_fn, state["params"])
        new_params, new_opt, info = adamw_update(state["params"], grads,
                                                 state["opt"], tc)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **parts, **info})
    return step


def finetune_heads(drafter: HeadDrafter, target: Model, state, t_params,
                   batches: Iterator[np.ndarray], tc: TrainConfig, steps: int,
                   loss_kind: str = "tvdpp", log_every: int = 0,
                   callback=None):
    """Host loop over (B, S) token batches, every position counted (the
    counterpart of ``training.finetune`` for head parameters)."""
    step_fn = make_head_distill_step(drafter, target, tc, loss_kind)
    history = []
    for i in range(steps):
        chunk = torch.as_tensor(next(batches), dtype=torch.long,
                                device=target.device)
        mask = torch.ones(chunk.shape, dtype=torch.float32, device=target.device)
        state, metrics = step_fn(state, t_params, chunk, mask)
        log_metrics(history, i, metrics, log_every, callback)
    return state, history

"""Phase-1 pretraining (paper §2.1): plain next-token prediction on the open
corpus, AdamW + WarmUpDecayLR (paper §A.3) (``repro.training.pretrain``).

A step is a function of the state ``{"params", "opt"}`` that returns a new
state, as in the reference; metrics stay tensors on the card until the
host loop reads them every ``log_every`` steps."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..data.packing import shift_labels
from ..models.model import Model
from ..optim import adamw_update, init_opt_state, tree_leaves, tree_map


def make_train_state(model: Model, seed: int, tc: TrainConfig):
    """Seeded parameters in ``param_dtype`` (float32 master weights) and a
    zeroed AdamW state in ``opt_state_dtype``."""
    params = model.init(seed, dtype=getattr(torch, model.cfg.param_dtype))
    opt = init_opt_state(params, getattr(torch, model.cfg.opt_state_dtype))
    return {"params": params, "opt": opt}


def value_and_grad(loss_fn, params, has_aux: bool = False):
    """(loss detached, gradients as a tree like ``params``) of the scalar
    ``loss_fn(params)``; ``params`` itself is left untouched. With
    ``has_aux``, as ``jax.value_and_grad``'s: ``loss_fn`` returns (loss,
    aux), a tree of tensors that gets no gradient, and the first item is
    (loss, aux), both detached."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, aux = loss_fn(p) if has_aux else (loss_fn(p), None)
    leaves = tree_leaves(p)
    # a leaf the loss never reads (a shared set no layer selects) gets a
    # zero gradient, as under jax.value_and_grad
    grads = iter([torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    grads = tree_map(lambda _: next(grads), p)
    if has_aux:
        return (loss.detach(), tree_map(torch.Tensor.detach, aux)), grads
    return loss.detach(), grads


def make_train_step(model: Model, tc: TrainConfig):
    def step(state, tokens, labels):
        (loss, parts), grads = value_and_grad(
            lambda p: model.loss_ce(p, tokens, labels), state["params"],
            has_aux=True)
        new_params, new_opt, info = adamw_update(state["params"], grads,
                                                 state["opt"], tc)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **parts, **info})
    return step


def log_metrics(history, i, metrics, log_every, callback):
    """Every ``log_every`` steps, read the metrics to the host (the only
    sync of the loop) and append them to ``history``."""
    if log_every and (i + 1) % log_every == 0:
        m = {k: float(v) for k, v in metrics.items()}
        history.append({"step": i + 1, **m})
        if callback:
            callback(i + 1, m)


def train(model: Model, state, batches: Iterator[np.ndarray], tc: TrainConfig,
          steps: int, log_every: int = 0, callback=None):
    """Simple host loop; ``batches`` yields (B, S) token chunks."""
    step_fn = make_train_step(model, tc)
    history = []
    for i in range(steps):
        inputs, labels = shift_labels(next(batches))
        state, metrics = step_fn(
            state, torch.as_tensor(inputs, dtype=torch.long, device=model.device),
            torch.as_tensor(labels, dtype=torch.long, device=model.device))
        log_metrics(history, i, metrics, log_every, callback)
    return state, history

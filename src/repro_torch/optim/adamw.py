"""AdamW in the reference's arithmetic order (``repro.optim.adamw``).

``torch.optim.AdamW`` orders its decay and bias correction differently, so
the update is written out here: m and v first, then
``p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)``. The step counter,
the learning rate and the gradient norm stay tensors on the parameters'
device, so an update never waits for the host.
"""
from __future__ import annotations

import torch

from ..configs.base import TrainConfig
from .schedule import warmup_decay_lr


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a nested dict/list tree (and of trees of
    the same structure in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The tensors of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def init_opt_state(params, dtype=torch.float32):
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def clip_by_global_norm(grads, max_norm: float):
    norm = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
    scale = (max_norm / norm.clamp(min=1e-9)).clamp(max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, opt_state, tc: TrainConfig):
    """-> (new params, new optimizer state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = warmup_decay_lr(step, tc.learning_rate, tc.min_learning_rate,
                         tc.warmup_steps, tc.total_steps)
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    b1, b2 = tc.beta1, tc.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    new_m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(m.dtype),
                     grads, opt_state["m"])
    new_v = tree_map(lambda g, v: b2 * v + (1 - b2) * g.to(v.dtype).square(),
                     grads, opt_state["v"])

    def upd(p, m, v):
        delta = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps) \
            + tc.weight_decay * p.to(m.dtype)
        return (p.float() - lr * delta.float()).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}

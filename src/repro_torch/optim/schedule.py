"""WarmUpDecayLR (paper §A.3, DeepSpeed semantics): linear warmup from 0 to
``max_lr`` over ``warmup_steps``, then linear decay to ``min_lr`` at
``total_steps`` (``repro.optim.schedule``)."""
from __future__ import annotations

import torch


def warmup_decay_lr(step, max_lr: float, min_lr: float, warmup_steps: int,
                    total_steps: int):
    """The learning rate at ``step`` (an int or a tensor, kept on its
    device) as a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = max_lr * step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = frac.clamp(0.0, 1.0)
    decay = max_lr + (min_lr - max_lr) * frac
    return torch.where(step < warmup_steps, warm, decay)

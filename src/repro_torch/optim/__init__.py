"""AdamW with decoupled weight decay, global-norm clipping and the
WarmUpDecayLR schedule (``repro.optim``), as plain functions over the
port's parameter trees (nested dicts and lists of tensors)."""
from .adamw import (adamw_update, clip_by_global_norm,  # noqa: F401
                    init_opt_state, tree_leaves, tree_map)
from .schedule import warmup_decay_lr  # noqa: F401

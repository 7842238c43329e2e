"""Drafter training (paper §2.1 and §2.3): pretraining by next-token
prediction and distillation fine-tuning against the frozen target."""
from .finetune import finetune, make_distill_step  # noqa: F401
from .pretrain import make_train_state, make_train_step, train  # noqa: F401

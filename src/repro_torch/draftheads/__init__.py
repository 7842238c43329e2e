"""Self-speculative draft heads (an EAGLE-style autoregressive head and
Medusa-style parallel heads) that read the target's hidden states: no
separate drafter weights, no drafter KV cache, no drafter pages
(``repro.draftheads``)."""
from .drafter import HeadDrafter, head_draft_chain, head_draft_tree, is_head_drafter
from .heads import HEAD_KINDS, HeadConfig, init_head_params
from .train import finetune_heads, make_head_distill_step, make_head_train_state

__all__ = [
    "HEAD_KINDS", "HeadConfig", "HeadDrafter", "init_head_params",
    "is_head_drafter", "head_draft_chain", "head_draft_tree",
    "make_head_train_state", "make_head_distill_step", "finetune_heads",
]

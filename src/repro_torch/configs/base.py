"""Model configuration for the port's dense, attention-only decoder.

A copy of the fields of ``repro.configs.base.ModelConfig`` that the dense
path reads; architectures that need the other fields (MoE, SSM, xLSTM,
sliding windows, multi-codebook heads) wait for later slices of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Layer kinds of the composable decoder stack (same strings as the reference).
ATTN = "attn"              # global full attention
LOCAL_ATTN = "local_attn"  # sliding-window attention (not ported yet)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    layer_pattern: Tuple[str, ...] = (ATTN,)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # activation/compute dtype; matmul weights are held in it as well
    # (models/layers.py), norm weights in float32
    dtype: str = "bfloat16"
    attn_chunk: int = 512              # query chunk of prefill attention
    drafter_overrides: Optional[Tuple[Tuple[str, object], ...]] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def pattern_blocks(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """Return (repeating group, group count, remainder kinds)."""
        g = self.layer_pattern
        n = self.num_layers // len(g)
        rem = self.num_layers - n * len(g)
        return g, n, g[:rem]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def drafter(self) -> "ModelConfig":
        """The reduced draft-model variant of this family."""
        over = dict(self.drafter_overrides or ())
        over.setdefault("name", self.name + "-drafter")
        return self.replace(**over)

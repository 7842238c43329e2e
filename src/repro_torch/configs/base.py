"""Model and training configuration for the port's dense, attention-only
decoder.

``ModelConfig`` copies the fields of ``repro.configs.base.ModelConfig`` that
the dense path reads; architectures that need the other fields (MoE, SSM,
xLSTM, sliding windows, multi-codebook heads) wait for later slices of the
port. ``TrainConfig`` and ``QuantConfig`` are copies of the reference's.
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
    # activation/compute dtype; served models hold their matmul weights in
    # it as well (models/layers.py), norm weights in float32
    dtype: str = "bfloat16"
    param_dtype: str = "float32"       # weights of a model under training
    opt_state_dtype: str = "float32"
    remat: bool = True                 # checkpoint each layer in training
    attn_chunk: int = 512              # query chunk of causal attention
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

    def param_count(self) -> int:
        """Analytic parameter count of the dense attention-only decoder
        (``repro``'s ``param_count`` on the fields the port has)."""
        d, hd = self.d_model, self.head_dim_
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        qkv = (d * (self.num_heads + 2 * self.num_kv_heads) * hd
               + self.num_heads * hd * d)
        per_layer = qkv + 3 * d * self.d_ff + 2 * d
        return emb + head + d + self.num_layers * per_layer

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


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule settings (paper §A.3)."""

    learning_rate: float = 1e-4
    min_learning_rate: float = 1e-6
    warmup_steps: int = 5000
    total_steps: int = 100_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    batch_size: int = 496
    seq_len: int = 2048               # paper §A.4 chunk length
    loss: str = "ce"                  # ce | kld | tvd | tvdpp (distill losses)
    distill_mix: float = 0.9          # 9:1 distill:pretrain mixing (paper §2.3)


@dataclass(frozen=True)
class QuantConfig:
    """Post-training quantization settings (``repro_torch.quant``).

    ``weights``: None (full precision) | "int8" (per-out-channel absmax) |
    "int4" (grouped absmax, ``group_size`` input channels per scale).
    ``awq``: apply the AWQ-lite activation-aware pre-scale when calibration
    data is provided. KV-cache quantization is a choice of cache layout,
    not a transform of the parameters, so it lives where caches are built:
    ``SDConfig.kv_quant`` and ``init_cache(kv_quant=)``.
    """

    weights: Optional[str] = None      # None | "int8" | "int4"
    group_size: int = 64               # int4 scale group along the in-dim
    awq: bool = True
    awq_alpha: float = 0.5

    def __post_init__(self):
        if self.weights not in (None, "int8", "int4"):
            raise ValueError(f"unsupported weights mode {self.weights!r}")

    @property
    def bits(self) -> int:
        return {None: 0, "int8": 8, "int4": 4}[self.weights]

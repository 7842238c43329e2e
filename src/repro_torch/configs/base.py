"""Model and training configuration of the port (``repro.configs.base``).

``ModelConfig`` is a copy of the reference's, field for field, covering the
dense, MoE, SSM, hybrid, VLM and audio architectures of the registry;
``models.transformer.check_config`` refuses a layer kind the port does not
know. ``ShapeConfig`` with the assigned ``INPUT_SHAPES`` of the dry run,
``TrainConfig`` and ``QuantConfig`` are copies of the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Layer kinds of the composable decoder stack (same strings as the reference).
ATTN = "attn"              # global full attention
LOCAL_ATTN = "local_attn"  # sliding-window attention
MAMBA = "mamba"            # Mamba2 / SSD block
MLSTM = "mlstm"            # xLSTM matrix-LSTM block
SLSTM = "slstm"            # xLSTM scalar-LSTM block
SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering dense / moe / ssm / hybrid / vlm / audio."""

    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    citation: str = ""

    # --- attention details -------------------------------------------------
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None     # gemma2 attention-logit softcap
    final_softcap: Optional[float] = None    # gemma2 final-logit softcap
    sliding_window: int = 4096               # span for LOCAL_ATTN layers
    # repeating block pattern; total layers = num_layers and
    # num_layers % len(layer_pattern) need not be 0 (remainder truncates).
    layer_pattern: Tuple[str, ...] = (ATTN,)
    qk_norm: bool = False              # RMSNorm of q and k per head, before RoPE

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256               # SSD chunk length (training)
    # hybrid (zamba2): a shared-weight attention block after every
    # `shared_attn_period` ssm layers, alternating between
    # `num_shared_attn_sets` weight sets.
    shared_attn_period: int = 0
    num_shared_attn_sets: int = 2

    # --- multimodal --------------------------------------------------------
    num_codebooks: int = 1             # musicgen: EnCodec codebooks
    scale_embed: bool = False          # gemma2: embeddings scaled by sqrt(d)

    # --- numerics / misc ----------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # activation/compute dtype; served models hold their matmul weights in
    # it as well (models/layers.py), norm weights in float32
    dtype: str = "bfloat16"
    param_dtype: str = "float32"       # weights of a model under training
    opt_state_dtype: str = "float32"   # grok/chameleon use bf16 to fit HBM
    remat: bool = True                 # checkpoint each layer in training
    attn_chunk: int = 512              # query chunk of causal attention
    # long-context serving: dense archs fall back to a ring-buffer
    # sliding-window KV cache of this many positions.
    long_context_window: int = 8192

    # the reduced draft variant of the family (speculative pairing)
    drafter_overrides: Optional[Tuple[Tuple[str, object], ...]] = None

    # ------------------------------------------------------------------ api
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

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

    def param_count(self) -> int:
        """Analytic parameter count, every layer kind included (MBSU's c
        ratio); the reference's arithmetic, which leaves out the 2 * hd
        qk-norm weights a layer of a ``qk_norm`` model holds."""
        d, hd = self.d_model, self.head_dim_
        emb = self.vocab_size * d * self.num_codebooks
        head = 0 if self.tie_embeddings else self.vocab_size * d * self.num_codebooks
        per = {}
        qkv = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
        ffn = 3 * d * self.d_ff
        per[ATTN] = qkv + ffn + 2 * d
        per[LOCAL_ATTN] = per[ATTN]
        if self.is_moe:
            per[ATTN] = qkv + 2 * d + d * self.num_experts + self.num_experts * 3 * d * self.d_ff
            per[LOCAL_ATTN] = per[ATTN]
        d_in = self.ssm_expand * d
        nh = max(d_in // self.ssm_head_dim, 1)
        if self.ssm_state_dim:
            conv_dim = d_in + 2 * self.ssm_state_dim
            per[MAMBA] = (d * (2 * d_in + 2 * self.ssm_state_dim + nh)
                          + conv_dim * self.ssm_conv_width + 2 * nh
                          + d_in * d + d + d_in)
        per[MLSTM] = d * 3 * d_in + d_in * d + 3 * d_in + 2 * d + d_in
        per[SLSTM] = 4 * d * d + 4 * d * d + 4 * d + 2 * d + 3 * d * d
        g, n, rem = self.pattern_blocks()
        total = emb + head + d  # + final norm
        for kind in list(g) * n + list(rem):
            if kind == SHARED_ATTN:
                continue
            total += per[kind]
        if self.shared_attn_period:
            total += self.num_shared_attn_sets * (qkv + 2 * d + ffn + d)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (see system brief)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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

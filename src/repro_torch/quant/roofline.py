"""Modeled bytes moved by one decode step of the quantized path
(``repro.quant.roofline``, dense attention-only models).

Decode is bound by memory: the model reads every live weight byte and
every live KV byte once per step, with the quantized dtypes and their scale
vectors made explicit. ``chip_smoke.py`` prints it beside the bytes the
quantized parameters really hold.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ATTN, LOCAL_ATTN, ModelConfig

_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}


@dataclass(frozen=True)
class DecodeBytes:
    weight_bytes: float
    scale_bytes: float          # quantization scale vectors (weights + KV)
    kv_bytes: float
    total: float

    def row(self):
        return (self.weight_bytes, self.scale_bytes, self.kv_bytes, self.total)


def attn_layer_count(cfg: ModelConfig) -> int:
    """Attention layers, each owning a KV cache."""
    g, n, rem = cfg.pattern_blocks()
    return sum(1 for k in list(g) * n + list(rem) if k in (ATTN, LOCAL_ATTN))


def decode_step_bytes(cfg: ModelConfig, batch: int, ctx: int,
                      weights: str = "float32", kv: str = "bfloat16",
                      group_size: int = 64) -> DecodeBytes:
    """Modeled device bytes per decode step (whole model).

    weights: "float32" | "bfloat16" | "int8" | "int4"; kv: "bfloat16" |
    "int8". Only the matmul weights that ``quantize_params`` quantizes
    (QKV/out projections, SwiGLU, lm head) are billed at the quantized
    width; embeddings and norms stay at ``cfg.param_dtype`` on both sides
    of the comparison. Scale overhead: per-out-channel fp32 for int8
    weights, per ``group_size`` input group for int4, per-(slot, head) fp32
    for int8 KV."""
    wb = _BYTES[weights]
    scale = 0.0
    L = attn_layer_count(cfg)
    if weights in ("int8", "int4"):
        d, hd = cfg.d_model, cfg.head_dim_
        mats = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
                (d, cfg.num_kv_heads * hd), (cfg.num_heads * hd, d)]
        if cfg.d_ff > 0:
            mats += [(d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
        q_params = L * sum(K * N for K, N in mats)
        head = 0
        if not cfg.tie_embeddings:       # tied: no separate lm_head weight
            q_params += d * cfg.vocab_size
            head = ((d // group_size) * cfg.vocab_size
                    if weights == "int4" else cfg.vocab_size)
        q_params = min(q_params, cfg.param_count())
        fpb = _BYTES.get(cfg.param_dtype, 4.0)
        w_bytes = q_params * wb + (cfg.param_count() - q_params) * fpb
        per_layer = sum((K // group_size) * N if weights == "int4" else N
                        for K, N in mats)
        scale += 4.0 * (L * per_layer + head)
    else:
        w_bytes = cfg.param_count() * wb
    kvb = _BYTES[kv]
    kv_bytes = batch * ctx * L * cfg.num_kv_heads * cfg.head_dim_ * 2 * kvb
    if kv == "int8":
        scale += batch * ctx * L * cfg.num_kv_heads * 2 * 4.0
    return DecodeBytes(w_bytes, scale, kv_bytes, w_bytes + scale + kv_bytes)

"""Roofline terms of a step on the H100, from closed-form models
(``repro.launch.roofline`` with the H100's constants; no hardware read).

  compute term    = FLOPs / (chips x 989 TFLOP/s bf16)
  memory term     = HBM bytes / (chips x 3.35 TB/s)
  collective term = collective bytes / (chips x 450 GB/s NVLink)

The FLOP and HBM-byte models below are the reference's formulas, copied
term for term; ``active_params`` and ``model_flops`` give MODEL_FLOPS = 6 N
D (train) / 2 N D (inference), N = active non-embedding params, and
MODEL_FLOPS / FLOPs exposes remat and dispatch waste. The bytes model keeps
the reference's 16-way model axis and 256-chip batch divisor.

The reference parses collective bytes out of post-SPMD HLO; the port
counts them in a sharded trace of the step on DTensors
(``launch.collectives.StepRecorder`` in ``launch.dryrun``): one rank's
result bytes by kind, which ``analyze`` takes as the collective bytes per
chip. DTensor, not XLA's GSPMD, chooses the collectives of a whole step,
so those bytes are the port's own model numbers.
"""
from __future__ import annotations

from ..configs.base import (ATTN, LOCAL_ATTN, MAMBA, MLSTM, SHARED_ATTN,
                            SLSTM, ModelConfig, ShapeConfig)

# NVIDIA H100 SXM data sheet, dense rates at 700 W:
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
LINK_BW = 450e9              # NVLink 4 bytes/s per card, one direction
HBM_BYTES = 80e9             # HBM per card

# ======================================================== analytic flops/bytes

def _layer_flops_per_token(cfg: ModelConfig, kind: str, ctx: int,
                           kind_decode: bool) -> float:
    """Forward matmul flops for one token through one block."""
    d, hd = cfg.d_model, cfg.head_dim_
    H, Hkv, F = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    fl = 0.0
    if kind in (ATTN, LOCAL_ATTN, SHARED_ATTN):
        fl += 2 * d * (H + 2 * Hkv) * hd          # qkv proj
        fl += 4 * H * hd * ctx                    # scores + values
        fl += 2 * H * hd * d                      # out proj
        if cfg.is_moe:
            fl += 2 * d * cfg.num_experts         # router
            fl += 6 * d * F * cfg.num_experts_per_tok * cfg.moe_capacity_factor
        elif F > 0:
            fl += 6 * d * F
    elif kind == MAMBA:
        d_in = cfg.ssm_expand * d
        nh = max(d_in // cfg.ssm_head_dim, 1)
        p = d_in // nh
        N = cfg.ssm_state_dim
        fl += 2 * d * (2 * d_in + 2 * N + nh)     # in proj
        fl += 2 * cfg.ssm_conv_width * (d_in + 2 * N)
        if kind_decode:
            fl += 6 * nh * p * N                  # state update + readout
        else:
            Q = cfg.ssm_chunk
            fl += 2 * Q * (N + nh * p) + 4 * nh * p * N
        fl += 2 * d_in * d                        # out proj
    elif kind == MLSTM:
        d_in = max(cfg.ssm_expand, 1) * d
        nh = cfg.num_heads
        p = d_in // nh
        fl += 2 * d * 2 * d_in + 3 * 2 * d_in * d_in
        if kind_decode:
            fl += 6 * nh * p * (p + 1)
        else:
            Q = cfg.ssm_chunk
            fl += 2 * Q * (nh * p) * 2 + 4 * nh * p * (p + 1)
        fl += 2 * d_in * d
    elif kind == SLSTM:
        nh = cfg.num_heads
        ph = d // nh
        fl += 2 * d * 4 * d + 2 * 4 * d * ph + 2 * d * d
    return fl


def flops_model(cfg: ModelConfig, shape: ShapeConfig,
                long_context: bool = False) -> float:
    """Total step flops across all chips (fwd for inference, fwd+bwd+remat
    for training)."""
    g, n, rem = cfg.pattern_blocks()
    kinds = list(g) * n + list(rem)
    decode = shape.kind == "decode"
    tokens = shape.global_batch * (1 if decode else shape.seq_len)

    def ctx_for(kind):
        if kind == LOCAL_ATTN:
            w = cfg.sliding_window
            return min(w, shape.seq_len)
        if decode:
            return min(cfg.long_context_window, shape.seq_len) if long_context \
                else shape.seq_len
        return shape.seq_len / 2.0                # causal average

    fwd = sum(_layer_flops_per_token(cfg, k, ctx_for(k), decode) for k in kinds)
    # lm head: every token in train; per generated token otherwise
    head_tokens = tokens if shape.kind == "train" else shape.global_batch
    head = 2 * cfg.d_model * cfg.vocab_size * cfg.num_codebooks
    if shape.kind == "train":
        mult = 4.0 if cfg.remat else 3.0          # fwd + bwd(2x) (+ remat fwd)
        return mult * fwd * tokens + 3.0 * head * head_tokens
    return fwd * tokens + head * head_tokens


def bytes_model(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                long_context: bool = False, profile: str = "baseline",
                msize: int = 16) -> float:
    """Per-chip HBM traffic per step (coefficients documented in DESIGN).

    Inference param traffic: each chip reads its TP shard (params/16) per
    step — under baseline ZeRO the gathered copy is read from HBM too, so
    /msize (not /chips) is the honest divisor for both profiles; the profiles
    differ in the *collective* term and in serve dtype (optimized = bf16).
    ``msize`` is the mesh's model-axis size: the reference fixes it at 16."""
    serve_bf16 = profile == "optimized" or cfg.param_dtype == "bfloat16"
    inference = shape.kind != "train"
    pb = 2 if (serve_bf16 and inference) or cfg.param_dtype == "bfloat16" else 4
    pbytes = cfg.param_count() * pb
    if inference and cfg.is_moe:
        # expert weights stay fsdp+tp sharded (/chips) even at inference
        # (weight-stationary path); only non-expert params are /msize.
        g_, n_, rem_ = cfg.pattern_blocks()
        n_moe = sum(1 for k in list(g_) * n_ + list(rem_)
                    if k in ("attn", "local_attn"))
        expert_b = n_moe * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * pb
        p_local = (pbytes - expert_b) / msize + expert_b / chips
    else:
        p_local = pbytes / (msize if inference else chips)
    obytes = cfg.param_count() * (2 if cfg.opt_state_dtype == "bfloat16" else 4)
    o_local = obytes / chips
    d = cfg.d_model
    g, n, rem = cfg.pattern_blocks()
    L = len(list(g) * n + list(rem))
    tokens_local = shape.global_batch * (1 if shape.kind == "decode"
                                         else shape.seq_len) / min(chips, 256)
    act = tokens_local * d * 2 * L * 12           # ~12 rw / layer, bf16
    if shape.kind == "train":
        p_train = pbytes / chips
        # params: fwd + bwd + remat reads, grad w+r, update w; opt m,v r+w
        return (4 * p_train) + (3 * p_train) + (4 * o_local) + act * 2
    if shape.kind == "prefill":
        return p_local + act
    # decode: params + cache traffic
    cache = _cache_bytes(cfg, shape, long_context) / chips
    return p_local + cache + tokens_local * d * 2 * L * 12


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig, long_context: bool) -> float:
    g, n, rem = cfg.pattern_blocks()
    kinds = list(g) * n + list(rem)
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    d_in = cfg.ssm_expand * cfg.d_model
    nh = max(d_in // cfg.ssm_head_dim, 1) if cfg.ssm_state_dim else 0
    p = d_in // nh if nh else 0
    for k in kinds:
        if k in (ATTN, LOCAL_ATTN, SHARED_ATTN):
            w = cfg.sliding_window if k == LOCAL_ATTN else \
                (cfg.long_context_window if long_context else S)
            total += B * min(w, S) * cfg.num_kv_heads * cfg.head_dim_ * 2 * 2
        elif k == MAMBA:
            total += B * nh * p * cfg.ssm_state_dim * 4
        elif k == MLSTM:
            din = max(cfg.ssm_expand, 1) * cfg.d_model
            ph = din // cfg.num_heads
            total += B * cfg.num_heads * ph * (ph + 1) * 4
        elif k == SLSTM:
            total += B * cfg.d_model * 4 * 4
    return total


def active_params(cfg: ModelConfig) -> float:
    total = cfg.param_count()
    total -= cfg.vocab_size * cfg.d_model * cfg.num_codebooks
    if cfg.is_moe:
        g, n, rem = cfg.pattern_blocks()
        n_moe = sum(1 for k in list(g) * n + list(rem) if k in (ATTN, LOCAL_ATTN))
        total -= n_moe * (cfg.num_experts - cfg.num_experts_per_tok) * 3 \
            * cfg.d_model * cfg.d_ff
    return float(total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


# ======================================================== terms + report

def roofline_terms(flops_per_chip, hbm_bytes_per_chip, coll_bytes_per_chip):
    t_comp = flops_per_chip / PEAK_FLOPS
    t_mem = hbm_bytes_per_chip / HBM_BW
    t_coll = coll_bytes_per_chip / LINK_BW
    dom = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "bottleneck": dom[1], "t_bound_s": dom[0]}


def analyze(cfg: ModelConfig, shape: ShapeConfig, chips: int,
            long_context: bool = False, profile: str = "baseline",
            msize: int = 16, collectives=None) -> dict:
    """The reference's ``analyze`` with counted collectives in place of
    the HLO: analytic flops and HBM bytes per chip, and the compute,
    memory and collective terms at the H100's rates. ``collectives`` is
    one rank's {kind: result bytes} of the sharded trace
    (``launch.collectives``); their sum is the collective bytes per chip
    and the bottleneck is the largest of the three terms. Without them (a
    mesh stand-in that no process group backs) the collective fields are
    None and the bottleneck the larger of the other two. ``msize`` is the
    size of the mesh's model axis (the reference's 16; 1 on one card)."""
    fl = flops_model(cfg, shape, long_context) / chips
    byts = bytes_model(cfg, shape, chips, long_context, profile, msize)
    coll = None if collectives is None else float(sum(collectives.values()))
    terms = roofline_terms(fl, byts, coll or 0.0)
    if coll is None:
        terms["t_collective_s"] = None
    mf = model_flops(cfg, shape)
    return {
        "arch": cfg.name, "shape": shape.name, "chips": chips,
        "flops_per_chip": fl, "hbm_bytes_per_chip": byts,
        "collective_bytes_per_chip": coll,
        "collectives": None if collectives is None else dict(collectives),
        **terms,
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / chips / fl) if fl else 0.0,
    }

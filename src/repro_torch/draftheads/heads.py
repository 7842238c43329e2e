"""Self-speculative draft heads: parameters and forward passes
(``repro.draftheads.heads``).

Two head families read the *target's* final hidden states instead of
running a separate drafter model:

EAGLE-style autoregressive head (``kind="eagle"``)
    One transformer block and the target's LM head over the fused pair
    (previous position's feature, embedding of the previous token):

        x_i = W_fuse [feat_{i-1} ; E(t_i)]          (2D -> D fusion)
        g_i = Block(x_i | attends the fused inputs on its root path)
        p_{i+1} = softmax(LMHead(norm(g_i)))

    ``feat`` is the target's final hidden state at round start and the
    head's own block output ``g`` after that. The block attends only the
    fused inputs of the current round (chain: the drafted prefix; tree: the
    node's ancestors), so the head keeps no state between rounds: no KV
    cache, no pages.

Medusa-style parallel heads (``kind="medusa"``)
    K residual-SiLU projections of one target hidden state; head k predicts
    the token k positions past the next one:

        p_{+k} = softmax(LMHead(norm_k(h + silu(h W_k))))

Both reuse the target's embedding table and LM head. The reference keeps
head weights in ``param_dtype`` (float32) and casts them to the activation
dtype at every matmul; a served head holds its matmul weights in the
target's compute dtype instead (``init_head_params(..., dtype=)``, or
``bridge.head_params_from_jax``), which gives every product the same
values without a cast of 302M weights per EAGLE step. A head under
training keeps float32 master weights. Norm weights are float32 always.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models import transformer as tfm
from ..models.layers import (dense_param, matmul_param, rms_norm, swiglu,
                             trunc_normal)

HEAD_KINDS = ("eagle", "medusa")


@dataclass(frozen=True)
class HeadConfig:
    """A draft-head family attached to one target. ``d_model`` and
    ``vocab_size`` must match the target (checkpoints record and check
    them)."""

    kind: str                     # "eagle" | "medusa"
    d_model: int
    vocab_size: int
    num_heads: int = 4            # attention heads of the eagle block
    d_ff: int = 0                 # eagle block FFN width (0 -> 4 * d_model)
    num_medusa_heads: int = 4     # K parallel offset heads
    norm_eps: float = 1e-5
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.kind not in HEAD_KINDS:
            raise ValueError(f"unknown head kind {self.kind!r}; one of {HEAD_KINDS}")
        if self.d_model % self.num_heads != 0:
            raise ValueError(
                f"d_model {self.d_model} not divisible by num_heads {self.num_heads}")

    @property
    def d_ff_(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def for_target(cls, kind: str, cfg, **kw) -> "HeadConfig":
        """A head config matching a target ``ModelConfig``."""
        kw.setdefault("num_heads", cfg.num_heads)
        return cls(kind=kind, d_model=cfg.d_model, vocab_size=cfg.vocab_size,
                   norm_eps=cfg.norm_eps, **kw)

    def param_count(self) -> int:
        """Drafter parameters; the embedding and LM head are the target's
        and not counted."""
        D = self.d_model
        if self.kind == "eagle":
            # fuse + attn (q, k, v, o) + swiglu + the three norms
            return 2 * D * D + 4 * D * D + 3 * D * self.d_ff_ + 3 * D
        return self.num_medusa_heads * (D * D + D)


def head_param_shapes(hc: HeadConfig) -> dict:
    """The parameter tree's leaf shapes: {path tuple: shape}."""
    D, F_ = hc.d_model, hc.d_ff_
    if hc.kind == "eagle":
        return {("fuse",): (2 * D, D), ("norm1",): (D,),
                **{("attn", w): (D, D) for w in ("wq", "wk", "wv", "wo")},
                ("norm2",): (D,), ("mlp", "w_gate"): (D, F_),
                ("mlp", "w_up"): (D, F_), ("mlp", "w_down"): (F_, D),
                ("out_norm",): (D,)}
    K = hc.num_medusa_heads
    return {("heads", "w"): (K, D, D), ("heads", "norm"): (K, D)}


def init_head_params(gen, hc: HeadConfig, device, dtype=None):
    """Seeded head parameters drawn from ``gen``: matmul weights in
    ``dtype`` (by default ``hc.param_dtype``), norms zero in float32.
    Medusa weights start near zero, so each head starts as "norm(h) ->
    the target's LM head", about the target's own next-token distribution
    (the Medusa warm start)."""
    dtype = dtype or getattr(torch, hc.param_dtype)
    D = hc.d_model
    if hc.kind == "eagle":
        def dense(i, o):
            return dense_param(gen, i, o, dtype, device)

        def norm():
            return torch.zeros((D,), dtype=torch.float32, device=device)

        return {"fuse": dense(2 * D, D), "norm1": norm(),
                "attn": {w: dense(D, D) for w in ("wq", "wk", "wv", "wo")},
                "norm2": norm(),
                "mlp": {"w_gate": dense(D, hc.d_ff_), "w_up": dense(D, hc.d_ff_),
                        "w_down": dense(hc.d_ff_, D)},
                "out_norm": norm()}
    K = hc.num_medusa_heads
    return {"heads": {
        "w": trunc_normal(gen, (K, D, D), 1e-2 / math.sqrt(D), dtype, device),
        "norm": torch.zeros((K, D), dtype=torch.float32, device=device)}}


# ---------------------------------------------------------------- eagle

def eagle_fuse(hp, t_params, feat, toks):
    """x = W_fuse [feat ; E(tok)]: feat (B, T, D) parent features, toks
    (B, T) the new nodes' token ids, embedded by the target's table."""
    emb = t_params["embed"][toks].to(feat.dtype)
    return matmul_param(torch.cat([feat, emb], dim=-1), hp["fuse"])


def eagle_block(hp, hc: HeadConfig, x, hist, mask):
    """One pre-norm transformer block over in-round fused inputs.

    x:    (B, T, D) fused inputs of the T nodes expanded now
    hist: (B, M, D) fused inputs of the nodes expanded before this round's
          level (M >= 0)
    mask: (B, T, M+T) bool, query t may attend key j (ancestors for trees,
          causality for chains)

    Returns the block output features (B, T, D). Scores and softmax are in
    float32, as in the reference (a plain einsum there, not a kernel).
    """
    B, T, D = x.shape
    H, hd = hc.num_heads, hc.head_dim
    h_all = torch.cat([hist, x], dim=1) if hist.shape[1] else x
    hn = rms_norm(h_all, hp["norm1"], hc.norm_eps)
    xn = hn[:, h_all.shape[1] - T:]
    q = matmul_param(xn, hp["attn"]["wq"]).reshape(B, T, H, hd)
    k = matmul_param(hn, hp["attn"]["wk"]).reshape(B, -1, H, hd)
    v = matmul_param(hn, hp["attn"]["wv"]).reshape(B, -1, H, hd)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    scores = torch.where(mask[:, None], scores, -1e30)
    att = torch.softmax(scores, dim=-1).to(v.dtype)
    y = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, D)
    y = x + matmul_param(y, hp["attn"]["wo"])
    return y + swiglu(hp["mlp"], rms_norm(y, hp["norm2"], hc.norm_eps))


def eagle_logits(hp, t_params, t_cfg, hc: HeadConfig, g):
    """Block output -> fp32 logits through the target's LM head."""
    return tfm.logits_from_hidden(
        t_params, rms_norm(g, hp["out_norm"], hc.norm_eps), t_cfg)


# ---------------------------------------------------------------- medusa

def medusa_logits(hp, t_params, t_cfg, hc: HeadConfig, h):
    """h (..., D) target hidden -> (..., K, V) fp32 logits; slot k-1 of the
    K axis is head k, predicting the token k positions past the one the
    target's own LM head predicts from ``h``. The K features share one LM
    head product."""
    w, norms = hp["heads"]["w"], hp["heads"]["norm"]
    feats = torch.stack([h + F.silu(matmul_param(h, w[k]))
                         for k in range(w.shape[0])], dim=-2)
    return tfm.logits_from_hidden(t_params, rms_norm(feats, norms, hc.norm_eps),
                                  t_cfg)

"""Mamba2 / SSD block of zamba2's hybrid backbone (``repro.models.ssm``).

Training and prefill run the chunked SSD algorithm (Dao & Gu, 2024): the
sequence is split into chunks of ``cfg.ssm_chunk``; within a chunk the
recurrence is a small quadratic form evaluated by batched matmuls, and
the chunk-boundary states are carried by a Python loop over the chunks.
Everything inside is float32, as in the reference. The widest tensors
formed are (B, nc, H, Q, Q) and (B, nc, H, P, N): each three-operand
contraction of the reference is split into an elementwise product and a
batched matmul over (b, c, h), so that no (B, nc, Q, Q, H, P) product is
ever materialised.

Decode keeps a recurrent state (B, H, P, N) float32 and a causal-conv tail
(B, w-1, conv_dim) in the compute dtype, and advances one token (or T, in
a Python loop) per call. Decode returns new state tensors and never
writes into the ones it was given, so a cache dict held from an earlier
call stays as it was (``core.speculative`` rewinds by keeping them).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import context as shctx
from .layers import matmul_param, rms_norm, trunc_normal


def ssm_dims(cfg):
    """(d_in, SSD heads, head dim, state dim N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = max(d_in // cfg.ssm_head_dim, 1)
    return d_in, nheads, d_in // nheads, cfg.ssm_state_dim


def init_mamba(gen, cfg, wdt, device):
    """The block's parameters: the fused input projection [z, x, B, C, dt]
    and the output projection in ``wdt``; the conv, gates, skip and norm
    in float32, as the reference holds them (its conv multiplies the
    compute-dtype input by float32 weights)."""
    d = cfg.d_model
    d_in, nh, _, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * N
    f32 = torch.float32

    def zeros(n):
        return torch.zeros((n,), dtype=f32, device=device)

    return {
        "w_in": trunc_normal(gen, (d, 2 * d_in + 2 * N + nh),
                             1.0 / math.sqrt(d), wdt, device),
        "conv_w": trunc_normal(gen, (cfg.ssm_conv_width, conv_dim), 0.5, f32,
                               device),
        "conv_b": zeros(conv_dim),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=device)),
        "dt_bias": zeros(nh),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "norm_w": zeros(d_in),
        "w_out": trunc_normal(gen, (d_in, d), 1.0 / math.sqrt(d_in), wdt,
                              device),
    }


def _split_in(cfg, proj):
    """proj (..., 2 d_in + 2N + H) -> (z, xBC, dt_raw)."""
    d_in, _, _, N = ssm_dims(cfg)
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
            proj[..., 2 * d_in + 2 * N:])


def _causal_conv(xBC, conv_w, conv_b, tail=None):
    """Depthwise causal conv1d of width w, SiLU after. xBC: (B, S, C);
    tail: (B, w-1, C), the previous call's last inputs (zeros at the
    start). Computed in float32 by one grouped ``conv1d``; returns (the
    float32 output, the new tail in xBC's dtype)."""
    if tail is None:    # a sharded step convolves a rank's rows, every
        # channel: DTensor's grouped conv1d cannot split the groups
        return shctx.batch_local(_conv_local, (xBC,), (conv_w, conv_b))
    return shctx.batch_local(lambda x, t, w, b: _conv_local(x, w, b, t),
                             (xBC, tail), (conv_w, conv_b))


def _conv_local(xBC, conv_w, conv_b, tail=None):
    w = conv_w.shape[0]
    B, S, C = xBC.shape
    if tail is None:
        tail = torch.zeros((B, w - 1, C), dtype=xBC.dtype, device=xBC.device)
    padded = torch.cat([tail.to(xBC.dtype), xBC], dim=1)
    out = F.conv1d(padded.float().transpose(1, 2),
                   conv_w.float().T[:, None, :], conv_b.float(), groups=C)
    # a copy: a view would keep the whole padded input alive in the cache
    new_tail = padded[:, -(w - 1):].clone() if w > 1 else tail
    return F.silu(out.transpose(1, 2)), new_tail


def _gates(params, dt_raw):
    """(step size dt, log-decay A * dt), both (..., H) float32."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return dt, -torch.exp(params["A_log"]) * dt


def chunked_ssd(xh, Bm, Cm, dt, log_decay, chunk):
    """Chunked SSD scan, float32.

    xh: (B, S, H, P) inputs; Bm/Cm: (B, S, N), shared by the heads; dt:
    (B, S, H); log_decay: (B, S, H), negative. Returns y (B, S, H, P) and
    the final state (B, H, P, N). A length that is no multiple of
    ``chunk`` runs as one chunk, as in the reference. A sharded step runs
    it on each rank's rows (``batch_local``)."""
    return shctx.batch_local(lambda *a: _chunked_ssd(*a, chunk),
                             (xh, Bm, Cm, dt, log_decay))


def _chunked_ssd(xh, Bm, Cm, dt, log_decay, chunk):
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q

    def r(t):
        return t.float().reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xh, Bm, Cm, dt, ld = r(xh), r(Bm), r(Cm), r(dt), r(log_decay)
    cum = ld.cumsum(2)                                     # (B, nc, Q, H)
    xdt = (xh * dt[..., None]).transpose(2, 3)             # (B, nc, H, Q, P)
    cum_h = cum.transpose(2, 3)                            # (B, nc, H, Q)
    # --- within a chunk: (C B^T * decay) @ (x dt) over (b, c, h)
    seg = cum_h[..., :, None] - cum_h[..., None, :]        # (B, nc, H, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    # double where: a masked entry has seg > 0, whose exp would overflow
    # and make the backward NaN if it were masked only after the exp
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    scores = Cm @ Bm.transpose(-1, -2)                     # (B, nc, Q, Q)
    y = (scores[:, :, None] * decay) @ xdt                 # (B, nc, H, Q, P)
    # --- each chunk's own state, decayed to its end
    w_end = torch.exp(cum_h[..., -1:] - cum_h)             # (B, nc, H, Q)
    states = (xdt * w_end[..., None]).transpose(-1, -2) @ Bm[:, :, None]
    chunk_decay = torch.exp(cum_h[..., -1])                # (B, nc, H)
    # --- the states entering each chunk, carried across the chunks
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, 1)                        # (B, nc, H, P, N)
    y_inter = (Cm[:, :, None] @ h_prev.transpose(-1, -2)) \
        * torch.exp(cum_h)[..., None]                      # (B, nc, H, Q, P)
    y = (y + y_inter).transpose(2, 3).reshape(Bsz, S, H, Pd)
    return y, h


def _out(params, y, xh, z, cfg, dtype):
    """D skip, gate by SiLU(z), RMSNorm, output projection."""
    B, S = y.shape[:2]
    y = y + params["D"][:, None] * xh.float()
    y = shctx.tp_layout(y.reshape(B, S, -1).to(dtype), y.shape[2])
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    return matmul_param(y, params["w_out"])


def _in(params, x, cfg, conv_tail):
    """Input projection, causal conv and gates: (z, xh (B, S, H, P), B, C,
    dt, log-decay, new conv tail)."""
    B, S, _ = x.shape
    d_in, nh, p, N = ssm_dims(cfg)
    z, xBC, dt_raw = _split_in(cfg, matmul_param(x, params["w_in"]))
    xBC, new_tail = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 conv_tail)
    xh = xBC[..., :d_in].reshape(B, S, nh, p)
    dt, ld = _gates(params, dt_raw)
    return z, xh, xBC[..., d_in:d_in + N], xBC[..., d_in + N:], dt, ld, new_tail


def mamba_forward(params, x, cfg):
    """x: (B, S, d) -> (y, (final state, conv tail)): the chunked path of
    training and prefill, from a zero state."""
    z, xh, Bm, Cm, dt, ld, new_tail = _in(params, x, cfg, None)
    y, hT = chunked_ssd(xh, Bm, Cm, dt, ld, cfg.ssm_chunk)
    return _out(params, y, xh, z, cfg, x.dtype), (hT, new_tail)


def mamba_decode(params, x, cfg, state, conv_tail):
    """Recurrent steps. x: (B, T, d), T small; state: (B, H, P, N) float32;
    conv_tail: (B, w-1, conv_dim). Returns (y, (new state, new tail))."""
    z, xh, Bm, Cm, dt, ld, new_tail = _in(params, x, cfg, conv_tail)
    y, h = ssd_steps(state, xh, Bm, Cm, dt, ld)
    return _out(params, y, xh, z, cfg, x.dtype), (h, new_tail)


def ssd_steps(h, xh, Bm, Cm, dt, ld):
    """The step recurrence from state h (B, H, P, N): for each of the T
    tokens h = exp(ld) h + (x dt) B^T, y = h C. Returns (y (B, T, H, P),
    the last state)."""
    return shctx.batch_local(_ssd_steps, (h, xh, Bm, Cm, dt, ld))


def _ssd_steps(h, xh, Bm, Cm, dt, ld):
    ys = []
    for t in range(xh.shape[1]):
        inp = (xh[:, t] * dt[:, t, :, None])[..., None] * Bm[:, t, None, None]
        h = torch.exp(ld[:, t])[:, :, None, None] * h + inp
        ys.append((h @ Cm[:, t, None, :, None]).squeeze(-1))     # (B, H, P)
    return torch.stack(ys, 1), h


def init_mamba_cache(cfg, batch, dtype, device):
    d_in, nh, p, N = ssm_dims(cfg)
    return {"state": torch.zeros((batch, nh, p, N), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * N),
                                dtype=dtype, device=device)}

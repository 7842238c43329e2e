"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent connections) of xlstm-1.3b
[arXiv:2405.04517].

mLSTM runs the chunked linear recurrence of the SSD block
(``models.ssm``) with per-head keys and queries: within a chunk a
quadratic form by batched matmuls over (b, c, h), the k-v outer-product
state (H, N, P) carried across chunks by a Python loop. The value gets a
ones channel, so the state is (B, H, N, P+1) and its last column
accumulates the normaliser. Gates are sigmoid(i) and log-sigmoid(f), the
reference's bounded gates in place of the paper's exponential input gate.

sLSTM is a sequential scan over time (a Python loop), with the paper's
m-stabiliser, which starts at -30. Its cache is {"c", "n", "h", "m"},
each (B, d) float32; the mLSTM cache is {"state"}. Decode and the scan
return new tensors and never write into the ones they were given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import context as shctx
from .layers import matmul_param, rms_norm, trunc_normal

# --------------------------------------------------------------------- mLSTM


def mlstm_dims(cfg):
    """(d_in, heads, head dim)."""
    d_in = max(cfg.ssm_expand, 1) * cfg.d_model
    return d_in, cfg.num_heads, d_in // cfg.num_heads


def init_mlstm(gen, cfg, wdt, device):
    """Projections in ``wdt``; the gate projection and biases and the norm
    in float32, as the reference holds them."""
    d = cfg.d_model
    d_in, nh, _ = mlstm_dims(cfg)
    f32 = torch.float32

    def dense(i, o, dtype=wdt):
        return trunc_normal(gen, (i, o), 1.0 / math.sqrt(i), dtype, device)

    return {
        "w_up": dense(d, 2 * d_in),
        "w_q": dense(d_in, d_in),
        "w_k": dense(d_in, d_in),
        "w_v": dense(d_in, d_in),
        "w_if": dense(d_in, 2 * nh, f32),
        "b_if": torch.cat([torch.zeros((nh,), dtype=f32, device=device),
                           torch.full((nh,), 3.0, dtype=f32, device=device)]),
        "norm_w": torch.zeros((d_in,), dtype=f32, device=device),
        "w_down": dense(d_in, d),
    }


def _mlstm_qkv(params, x, cfg):
    B, S, _ = x.shape
    _, nh, p = mlstm_dims(cfg)
    xi, z = matmul_param(x, params["w_up"]).chunk(2, dim=-1)
    q = shctx.tp_layout(matmul_param(xi, params["w_q"]), nh)
    k = shctx.tp_layout(matmul_param(xi, params["w_k"]), nh)
    v = shctx.tp_layout(matmul_param(xi, params["w_v"]), nh)
    q = q.reshape(B, S, nh, p) / math.sqrt(p)
    k = k.reshape(B, S, nh, p)
    v = v.reshape(B, S, nh, p)
    gates = xi.float() @ params["w_if"] + params["b_if"]
    ig, fg = gates.chunk(2, dim=-1)                      # (B, S, nh)
    return z, q, k, v, torch.sigmoid(ig), F.logsigmoid(fg)


def chunked_gla(v, k, q, gate_i, log_f, chunk):
    """Gated linear attention, chunked, float32, per head.

    v: (B, S, H, P), k/q: (B, S, H, N), gate_i/log_f: (B, S, H). Returns y
    (B, S, H, P) and the final state (B, H, N, P). A sharded step runs it
    on each rank's rows (``batch_local``)."""
    return shctx.batch_local(lambda *a: _chunked_gla(*a, chunk),
                             (v, k, q, gate_i, log_f))


def _chunked_gla(v, k, q, gate_i, log_f, chunk):
    B, S, H, Pd = v.shape
    N = k.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q

    def r(t):   # (B, S, H, ...) -> (B, nc, H, Q, ...), float32
        t = t.float().reshape((B, nc, Q) + tuple(t.shape[2:]))
        return t.transpose(2, 3)

    v, k, q, gi, cum = r(v), r(k), r(q), r(gate_i), r(log_f).cumsum(-1)
    vw = v * gi[..., None]                                 # (B, nc, H, Q, P)
    seg = cum[..., :, None] - cum[..., None, :]            # (B, nc, H, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=v.device).tril()
    # double where: see ssm.chunked_ssd (masked entries overflow exp in bwd)
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    y = ((q @ k.transpose(-1, -2)) * decay) @ vw           # (B, nc, H, Q, P)
    w_end = torch.exp(cum[..., -1:] - cum)                 # (B, nc, H, Q)
    states = (k * w_end[..., None]).transpose(-1, -2) @ vw  # (B, nc, H, N, P)
    chunk_decay = torch.exp(cum[..., -1])                  # (B, nc, H)
    h = torch.zeros((B, H, N, Pd), dtype=torch.float32, device=v.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    y_inter = (q @ torch.stack(h_prev, 1)) * torch.exp(cum)[..., None]
    return (y + y_inter).transpose(2, 3).reshape(B, S, H, Pd), h


def _with_ones(v):
    """The value with a ones channel appended (the normaliser), float32."""
    v = v.float()
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _mlstm_out(params, y_aug, z, cfg, dtype):
    B, S = y_aug.shape[:2]
    _, _, p = mlstm_dims(cfg)
    y = y_aug[..., :p] / y_aug[..., p:].abs().clamp(min=1.0)
    y = shctx.tp_layout(y.reshape(B, S, -1).to(dtype), cfg.num_heads)
    y = rms_norm(y, params["norm_w"], cfg.norm_eps) * F.silu(z)
    return matmul_param(y, params["w_down"])


def mlstm_forward(params, x, cfg):
    """x: (B, S, d) -> (y, final state (B, H, N, P+1)): the chunked path
    of training and prefill, from a zero state."""
    z, q, k, v, i, log_f = _mlstm_qkv(params, x, cfg)
    y_aug, hT = chunked_gla(_with_ones(v), k, q, i, log_f, cfg.ssm_chunk)
    return _mlstm_out(params, y_aug, z, cfg, x.dtype), hT


def mlstm_decode(params, x, cfg, state):
    """x: (B, T, d); state: (B, H, N, P+1) float32 (value and normaliser
    channels). Returns (y, new state)."""
    z, q, k, v, i, log_f = _mlstm_qkv(params, x, cfg)
    y_aug, h = gla_steps(state, q, k, _with_ones(v), i, log_f)
    return _mlstm_out(params, y_aug, z, cfg, x.dtype), h


def gla_steps(h, q, k, v, gate_i, log_f):
    """The step recurrence from state h (B, H, N, P): for each of the T
    tokens h = f h + i k v^T, y = q h. Returns (y (B, T, H, P), the last
    state)."""
    return shctx.batch_local(_gla_steps, (h, q, k, v, gate_i, log_f))


def _gla_steps(h, q, k, v, gate_i, log_f):
    ys = []
    for t in range(q.shape[1]):
        kv = (k[:, t].float() * gate_i[:, t, :, None])[..., None] * v[:, t, :, None]
        h = torch.exp(log_f[:, t])[:, :, None, None] * h + kv
        ys.append((q[:, t, :, None].float() @ h).squeeze(-2))   # (B, H, P)
    return torch.stack(ys, 1), h


def init_mlstm_cache(cfg, batch, device):
    _, nh, p = mlstm_dims(cfg)
    return {"state": torch.zeros((batch, nh, p, p + 1), dtype=torch.float32,
                                 device=device)}


# --------------------------------------------------------------------- sLSTM

def init_slstm(gen, cfg, wdt, device):
    """Input and output projections in ``wdt``; the recurrent weights,
    biases and norm in float32, as the reference reads them."""
    d = cfg.d_model
    nh = cfg.num_heads
    ph = d // nh
    f32 = torch.float32
    return {
        "w_gates": trunc_normal(gen, (d, 4 * d), 1.0 / math.sqrt(d), wdt,
                                device),
        "r_gates": trunc_normal(gen, (4, nh, ph, ph), 1.0 / math.sqrt(ph),
                                f32, device),
        "b_gates": torch.zeros((4 * d,), dtype=f32, device=device),
        "norm_w": torch.zeros((d,), dtype=f32, device=device),
        "w_out": trunc_normal(gen, (d, d), 1.0 / math.sqrt(d), wdt, device),
    }


def _slstm_scan(params, wx, cfg, carry):
    """wx: (B, S, 4d) input contributions; carry {"c", "n", "h", "m"}.
    Returns (new carry, h of every step (B, S, d) float32). A sharded step
    runs it on each rank's rows with the recurrent weights whole
    (``batch_local``)."""
    def local(wx, c, n, h, m, r, b):
        return _slstm_local({"r_gates": r, "b_gates": b}, wx, cfg,
                            {"c": c, "n": n, "h": h, "m": m})
    return shctx.batch_local(
        local, (wx, carry["c"], carry["n"], carry["h"], carry["m"]),
        (params["r_gates"], params["b_gates"]))


def _slstm_local(params, wx, cfg, carry):
    B, S, d4 = wx.shape
    d = d4 // 4
    nh = cfg.num_heads
    ph = d // nh
    r = params["r_gates"].float()                        # (4, nh, ph, ph)
    bias = params["b_gates"].float().reshape(4, d)
    c, n, h, m = carry["c"], carry["n"], carry["h"], carry["m"]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhp,ghpq->bghq", h.reshape(B, nh, ph), r)
        pre = wx[:, t].float().reshape(B, 4, d) + rec.reshape(B, 4, d) + bias
        zi, ii, fi, oi = pre.unbind(1)
        log_f = F.logsigmoid(fi)
        m_new = torch.maximum(log_f + m, ii)              # the stabiliser
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * torch.tanh(zi)
        n = f_p * n + i_p
        h = torch.sigmoid(oi) * c / n.clamp(min=1e-6)
        m = m_new
        hs.append(h)
    return {"c": c, "n": n, "h": h, "m": m}, torch.stack(hs, 1)


def slstm_forward(params, x, cfg, carry=None):
    """x: (B, S, d) from ``carry`` (a fresh one when None) -> (y, carry):
    training, prefill and decode alike."""
    if carry is None:
        carry = init_slstm_cache(cfg, x.shape[0], x.device)
    carry, hs = _slstm_scan(params, matmul_param(x, params["w_gates"]), cfg,
                            carry)
    hs = rms_norm(hs.to(x.dtype), params["norm_w"], cfg.norm_eps)
    return matmul_param(hs, params["w_out"]), carry


def init_slstm_cache(cfg, batch, device):
    def full(v):
        return torch.full((batch, cfg.d_model), v, dtype=torch.float32,
                          device=device)
    return {"c": full(0.0), "n": full(0.0), "h": full(0.0), "m": full(-30.0)}

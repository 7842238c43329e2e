"""Chain speculative decoding (Leviathan et al. 2023), batched
(``repro.core.speculative``, dense caches and a drafter model only).

Round protocol (committed length per row = L; ``pending`` = the last
committed token, not yet in either KV cache):

  draft  : feed [pending, x1 .. x_gamma] one token at a time, sampling
           x_{i+1} from the draft distribution p_{i+1} (gamma+1 feeds; the
           last keeps the draft cache complete on full acceptance).
  verify : the target scores the same gamma+1 tokens in ONE decode call
           (T = gamma+1) -> q_1 .. q_{gamma+1}.
  accept : x_i is accepted w.p. min(1, q_i(x_i)/p_i(x_i)); at the first
           rejection the replacement comes from norm(max(q - p, 0)); on
           full acceptance the bonus token comes from q_{gamma+1}.
  commit : accepted tokens enter the token buffer, and cache entries past
           the accepted prefix are invalidated (pos = -1).

Randomness comes from one ``torch.Generator``. A round may instead take a
``noise`` dict holding the exact draws the reference makes from its round
key: {"draft": (gamma, B, V) Gumbel, "u": (gamma, B) uniforms,
"residual": (B, V) Gumbel}.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ATTN, LOCAL_ATTN
from ..models.model import Model
from .metrics import SDStats
from .sampling import probs_from_logits, residual_sample, sample_from_probs


def attention_only(cfg) -> bool:
    g, _, rem = cfg.pattern_blocks()
    return all(k in (ATTN, LOCAL_ATTN) for k in tuple(g) + tuple(rem))


def trim_attn_cache(cache, limit):
    """Invalidate cache entries with position > limit (B,), in place."""
    for layer in cache:
        layer["pos"].masked_fill_(layer["pos"] > limit[:, None], -1)
    return cache


@dataclass(frozen=True)
class SDConfig:
    gamma: int = 3
    temperature: float = 1.0
    top_p: float = 1.0


def _pick(noise, name, i=None):
    if noise is None:
        return None
    return noise[name] if i is None else noise[name][i]


def sync(device) -> None:
    """Wait for the card, so that a host clock read next covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def commit_tokens(tokens, lengths, vals, n_acc):
    """Write vals[:, :n_acc+1] at lengths .. lengths+n_acc of each row, in
    place. Writes past the buffer are dropped, as the reference's scatter
    drops them (a finished row keeps running while others catch up)."""
    B, K = vals.shape
    bidx = torch.arange(B, device=tokens.device)[:, None]
    offs = torch.arange(K, device=tokens.device)[None]
    dst = lengths[:, None] + offs
    valid = (offs <= n_acc[:, None]) & (dst < tokens.shape[1])
    idx = torch.where(valid, dst, tokens.shape[1] - 1)
    tokens[bidx, idx] = torch.where(valid, vals, tokens[bidx, idx])
    return tokens


def sd_draft_phase(draft: Model, sdc: SDConfig, d_params, state, gen,
                   noise=None):
    """Sample x_1..x_gamma and keep their draft distributions. Returns
    {"x": (g, B), "p_stack": (g+1, B, V) with the bonus slot zeroed,
    "d_cache"}."""
    g = sdc.gamma
    lengths, pending = state["lengths"], state["pending"]
    d_cache = state["d_cache"]
    xs, ps = [], []
    tok = pending
    for j in range(g + 1):
        logits, d_cache = draft.decode_step(d_params, tok[:, None],
                                            (lengths + j)[:, None], d_cache)
        p = probs_from_logits(logits[:, 0], sdc.temperature, sdc.top_p)
        ps.append(p)
        if j < g:
            tok = sample_from_probs(p, gen, _pick(noise, "draft", j))
            xs.append(tok)
    x = (torch.stack(xs) if g > 0 else
         torch.zeros((0, pending.shape[0]), dtype=torch.long,
                     device=pending.device))
    p_stack = torch.stack(ps)
    p_stack[g] = 0.0                     # bonus slot: residual of 0 is q
    return {"x": x, "p_stack": p_stack, "d_cache": d_cache}


def sd_verify_phase(target: Model, sdc: SDConfig, t_params, state, draft_out):
    """One target decode over the gamma+1 speculated tokens. Returns
    {"q_stack": (g+1, B, V), "t_cache"}."""
    g = sdc.gamma
    lengths, pending = state["lengths"], state["pending"]
    feed = torch.cat([pending[:, None], draft_out["x"].T], dim=1)   # (B, g+1)
    positions = lengths[:, None] + torch.arange(g + 1, device=lengths.device)
    logits, t_cache = target.decode_step(t_params, feed, positions,
                                         state["t_cache"])
    q_stack = probs_from_logits(logits, sdc.temperature, sdc.top_p)
    return {"q_stack": q_stack.transpose(0, 1), "t_cache": t_cache}


def sd_commit_phase(sdc: SDConfig, state, draft_out, verify_out, gen,
                    noise=None):
    """Acceptance, residual sampling, token commit and cache rewind.
    Returns ``(new_state, n_acc)``."""
    g = sdc.gamma
    tokens, lengths, pending = state["tokens"], state["lengths"], state["pending"]
    x, p_stack = draft_out["x"], draft_out["p_stack"]
    q_stack = verify_out["q_stack"]
    B = pending.shape[0]
    dev = pending.device
    bidx = torch.arange(B, device=dev)
    if g > 0:
        gi = torch.arange(g, device=dev)[:, None]
        px = p_stack[gi, bidx[None], x]                                  # (g, B)
        qx = q_stack[gi, bidx[None], x]
        ratio = qx / px.clamp(min=1e-20)
        u = _pick(noise, "u")
        if u is None:
            u = torch.rand((g, B), generator=gen, device=dev)
        n_acc = (u < ratio).long().cumprod(0).sum(0)                     # (B,)
    else:
        n_acc = torch.zeros((B,), dtype=torch.long, device=dev)
    new_pending = residual_sample(q_stack[n_acc, bidx], p_stack[n_acc, bidx],
                                  gen, _pick(noise, "residual"))

    feed = torch.cat([pending[:, None], x.T], dim=1)                    # (B, g+1)
    tokens = commit_tokens(tokens, lengths, feed, n_acc)
    limit = lengths + n_acc               # keep cache positions <= limit
    new_state = {"tokens": tokens, "lengths": lengths + n_acc + 1,
                 "pending": new_pending,
                 "d_cache": trim_attn_cache(draft_out["d_cache"], limit),
                 "t_cache": trim_attn_cache(verify_out["t_cache"], limit)}
    return new_state, n_acc


def sd_round(draft: Model, target: Model, sdc: SDConfig, d_params, t_params,
             state, gen, noise=None):
    """One speculative block. state: {tokens, lengths, pending, d_cache,
    t_cache}; the caches are updated in place. Returns (new_state, n_acc)."""
    draft_out = sd_draft_phase(draft, sdc, d_params, state, gen, noise)
    verify_out = sd_verify_phase(target, sdc, t_params, state, draft_out)
    return sd_commit_phase(sdc, state, draft_out, verify_out, gen, noise)


def _prefill_state(draft: Model, target: Model, d_params, t_params, prompt,
                   max_total, sdc: SDConfig, gen, noise=None):
    """Prefill both models and sample the first pending token (``noise``:
    its (B, V) Gumbel noise)."""
    B, S = prompt.shape
    lg_t, t_cache = target.prefill(t_params, prompt, cache_len=max_total)
    _, d_cache = draft.prefill(d_params, prompt, cache_len=max_total)
    q0 = probs_from_logits(lg_t[:, 0], sdc.temperature, sdc.top_p)
    pending = sample_from_probs(q0, gen, noise)
    tokens = torch.zeros((B, max_total + sdc.gamma + 2), dtype=torch.long,
                         device=prompt.device)
    tokens[:, :S] = prompt
    lengths = torch.full((B,), S, dtype=torch.long, device=prompt.device)
    return {"tokens": tokens, "lengths": lengths, "pending": pending,
            "t_cache": t_cache, "d_cache": d_cache}


def run_rounds(round_fn, state, prompt_len: int, max_new_tokens: int):
    """Drive ``round_fn(state) -> (state, n_acc)`` until every row holds
    ``max_new_tokens`` new tokens. One host transfer per round brings back
    the lengths and n_acc together. Returns (state, stats)."""
    B = state["lengths"].shape[0]
    stats = SDStats()
    target_len = prompt_len + max_new_tokens
    lengths_host = np.full((B,), prompt_len, np.int64)
    t0 = time.perf_counter()
    while True:
        active = lengths_host < target_len
        if not active.any():
            break
        state, n_acc = round_fn(state)
        lengths_host, n_acc_host = torch.stack(
            [state["lengths"], n_acc]).cpu().numpy()
        stats.update_batch(n_acc_host[active] + 1)
        stats.rounds += 1
    stats.wall_time_s = time.perf_counter() - t0
    return state, stats


def speculative_generate(draft: Model, target: Model, d_params, t_params,
                         prompt, max_new_tokens: int, sdc: SDConfig, gen=None):
    """Generate ``max_new_tokens`` per row with chain speculative decoding.
    prompt: (B, S) int on the models' device. Returns (tokens, stats);
    stats count only rounds in which a row was still active."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    S = prompt.shape[1]
    max_total = S + max_new_tokens + sdc.gamma + 2
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           max_total, sdc, gen)

    def round_fn(st):
        return sd_round(draft, target, sdc, d_params, t_params, st, gen)

    state, stats = run_rounds(round_fn, state, S, max_new_tokens)
    return state["tokens"], stats


def autoregressive_generate(model: Model, params, prompt, max_new_tokens: int,
                            temperature: float = 1.0, top_p: float = 1.0,
                            gen=None):
    """Plain AR decoding baseline (one token per model call). Returns
    (tokens (B, S + max_new), decode wall time in seconds)."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    B, S = prompt.shape
    lg, cache = model.prefill(params, prompt, cache_len=S + max_new_tokens + 1)
    toks = [prompt]
    cur = sample_from_probs(probs_from_logits(lg[:, 0], temperature, top_p), gen)
    t0 = time.perf_counter()
    for i in range(max_new_tokens):
        toks.append(cur[:, None])
        if i == max_new_tokens - 1:
            break
        pos = torch.full((B, 1), S + i, dtype=torch.long, device=prompt.device)
        lg, cache = model.decode_step(params, cur[:, None], pos, cache)
        cur = sample_from_probs(probs_from_logits(lg[:, 0], temperature, top_p),
                                gen)
    out = torch.cat(toks, dim=1)
    sync(prompt.device)
    return out, time.perf_counter() - t0

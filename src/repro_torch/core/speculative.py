"""Chain speculative decoding (Leviathan et al. 2023), batched
(``repro.core.speculative``, with a drafter model or draft heads: dense
per-row caches, or the shared paged pool of continuous serving).

Round protocol (committed length per row = L; ``pending`` = the last
committed token, not yet in either KV cache):

  draft  : feed [pending, x1 .. x_gamma] one token at a time, sampling
           x_{i+1} from the draft distribution p_{i+1} (gamma+1 feeds; the
           last keeps the draft cache complete on full acceptance).
  verify : the target scores the same gamma+1 tokens in ONE decode call
           (T = gamma+1) -> q_1 .. q_{gamma+1}. A model with recurrent
           layers (Mamba, xLSTM, zamba2's hybrid) is fed one token a call
           instead, drafter and target alike, keeping a snapshot of its
           cache after each feed.
  accept : x_i is accepted w.p. min(1, q_i(x_i)/p_i(x_i)); at the first
           rejection the replacement comes from norm(max(q - p, 0)); on
           full acceptance the bonus token comes from q_{gamma+1}.
  commit : accepted tokens enter the token buffer, and cache entries past
           the accepted prefix are invalidated (pos = -1). A recurrent
           model's cache is rewound by selection first: each row takes the
           snapshot after its accepted prefix (``select_snapshot``), then
           its attention layers are trimmed by position.

Snapshots (the reference's ``d_snaps``/``t_snaps``). The port writes an
attention layer's new entries into its cache in place, so a snapshot
must never alias a tensor that a later feed writes into. A recurrent
layer's decode returns a new dict of new tensors and writes into none, so
the snapshot keeps that dict as it is: holding it is the copy, with no
bytes moved. An attention ring narrower than the positions it holds (a
windowed layer's, with ``long_context`` or Gemma's local layers) has its
oldest slots overwritten by later feeds, so its snapshot is a clone. Any
other attention layer is not kept: every feed writes a slot past the
accepted prefix, and trimming by position rewinds it exactly. Only the
last feed's cache is not snapshotted: it is the live one.

Two optional state keys serve continuous batching (serving.continuous):
``active`` (B,) bool freezes rows that are False (their lengths, pending
token and token commits are kept, and their page-table rows are masked to
the null page so their cache writes land there), and ``page_table`` (B,
max_pages) makes the caches paged pools (models.attention
.paged_decode_attention), rewound by ``trim_paged_cache``.

With a ``draftheads.HeadDrafter`` as ``draft`` the state holds no
``d_cache``; ``h_feat`` (B, D) holds the target's final hidden state at
the last committed position (L + n_acc, one before ``pending``). The draft
phase makes gamma head calls from it (``head_draft_chain``, which needs
the target and its parameters for the embedding and LM head), the verify
pass returns its hidden states, the commit takes ``h_feat`` from slot
n_acc (inactive rows keep theirs), and only the target cache is rewound.

Randomness comes from one ``torch.Generator``. A round may instead take a
``noise`` dict holding the exact draws the reference makes from its round
key: {"draft": (gamma, B, V) Gumbel, "u": (gamma, B) uniforms,
"residual": (B, V) Gumbel}.

With ``SDConfig.quality`` the commit phase also writes ``state["qual"]``
(``quality_buffer``): per-draft-depth TVD, target entropy and accept and
drafted masks, pure functions of the round's distributions that draw
nothing from the generator, so the tokens are the same with it on or off.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ATTN, LOCAL_ATTN, SHARED_ATTN
from ..draftheads.drafter import head_draft_chain, is_head_drafter
from ..models.model import Model
from ..models.transformer import layer_windows
from ..quant.kvcache import quantize_kv_cache
from .metrics import SDStats
from .sampling import probs_from_logits, residual_sample, sample_from_probs


def attention_only(cfg) -> bool:
    """No recurrent layer: zamba2's shared attention counts as attention."""
    g, _, rem = cfg.pattern_blocks()
    return all(k in (ATTN, LOCAL_ATTN, SHARED_ATTN)
               for k in tuple(g) + tuple(rem))


def trim_attn_cache(cache, limit):
    """Invalidate attention cache entries with position > limit (B,), in
    place; recurrent layers' caches are left alone. Keyed on the positions,
    not the slots, so a ring (a windowed layer's cache) is rewound the same
    way."""
    for layer in cache:
        if "pos" in layer:
            layer["pos"].masked_fill_(layer["pos"] > limit[:, None], -1)
    return cache


def ring_layers(model: Model, cache, long_context: bool):
    """Per layer: is it an attention ring that later feeds overwrite (a
    windowed layer whose cache holds no more slots than its window)?"""
    return [("pos" in c and w is not None and c["pos"].shape[1] <= w)
            for c, w in zip(cache, layer_windows(model.cfg, long_context))]


def snapshot(cache, rings):
    """The cache after a feed, as a rewind by selection needs it: a
    recurrent layer's dict as it is, a clone of an attention ring's, None
    for another attention layer (rewound by position)."""
    return [c if "pos" not in c else
            ({k: v.clone() for k, v in c.items()} if ring else None)
            for c, ring in zip(cache, rings)]


def select_snapshot(cache, snaps, n_acc):
    """Rewind by selection: in every layer that ``snaps`` keeps, row b
    takes the cache after n_acc[b] + 1 feeds, ``snaps[j]`` being the one
    after j + 1 feeds and the live ``cache`` the one after all of them.
    Returns the new list of layer dicts; other layers are ``cache``'s."""
    if not snaps:
        return cache
    bidx = torch.arange(n_acc.shape[0], device=n_acc.device)
    out = []
    for i, layer in enumerate(cache):
        if snaps[0][i] is None:
            out.append(layer)
            continue
        out.append({k: torch.stack([s[i][k] for s in snaps] + [v])[n_acc, bidx]
                    for k, v in layer.items()})
    return out


def trim_paged_cache(cache, page_table, limit):
    """Paged-pool rewind, in place: invalidate "page_pos" entries with
    position > the owning row's limit. page_table: (B, max_pages) physical
    ids (0 = null); limit: (B,). Each page's limit is the min of the limits
    of the rows whose tables hold it (null page 0 takes the min of all rows,
    harmless: it is never read). A page shared through the prefix cache
    holds only positions below every sharer's committed length, so the
    rewind cannot touch it."""
    P = cache[0]["page_pos"].shape[0]
    table = page_table.long()
    page_limit = torch.full((P,), torch.iinfo(torch.int32).max,
                            dtype=torch.long, device=table.device)
    page_limit.scatter_reduce_(
        0, table.reshape(-1),
        limit.long().repeat_interleave(table.shape[1]), "amin",
        include_self=True)
    for layer in cache:
        layer["page_pos"].masked_fill_(layer["page_pos"] > page_limit[:, None],
                                       -1)
    return cache


def masked_page_table(state):
    """The page table a round's decode calls use: inactive rows masked to
    the null page (0), so their cache writes land there. None when the
    state is unpaged."""
    page_table = state.get("page_table")
    if page_table is None:
        return None
    active = state.get("active")
    if active is None:
        return page_table
    return torch.where(active[:, None], page_table, 0)


def rewind_cache(state, cache, limit):
    """Keep cache positions <= limit (B,): a paged pool through the masked
    page table, a dense cache by its positions."""
    page_table = masked_page_table(state)
    if page_table is None:
        return trim_attn_cache(cache, limit)
    return trim_paged_cache(cache, page_table, limit)


def gate_rows(state, new_state):
    """Freeze the inactive rows of a continuous-batching state: their
    lengths, pending token and head feature stay, and the round passes
    ``active`` and ``page_table`` on."""
    active = state.get("active")
    if active is not None:
        for name in ("lengths", "pending", "h_feat"):
            if name in new_state:
                keep = active if name != "h_feat" else active[:, None]
                new_state[name] = torch.where(keep, new_state[name],
                                              state[name])
        new_state["active"] = active
    if state.get("page_table") is not None:
        new_state["page_table"] = state["page_table"]
    return new_state


@dataclass(frozen=True)
class SDConfig:
    gamma: int = 3
    temperature: float = 1.0
    top_p: float = 1.0
    # windowed global attention (``cfg.long_context_window``) in every
    # model call of the round, prefill included
    long_context: bool = False
    # int8 KV caches for both models (quant.kvcache): the prefill caches are
    # converted once, decode writes quantized entries directly
    kv_quant: bool = False
    # quality telemetry (obs.quality): the commit phase also writes
    # ``state["qual"]``, which the continuous engine fetches in its one
    # per-round device-to-host copy
    quality: bool = False


def init_quality_buffer(batch: int, depth: int, device):
    """Zeroed ``state["qual"]``: the round's output replaces it. ``depth``
    is gamma for chain rounds, the tree depth for tree rounds."""
    def zeros(dtype):
        return torch.zeros((batch, depth), dtype=dtype, device=device)
    return {"tvd": zeros(torch.float32), "ent": zeros(torch.float32),
            "acc": zeros(torch.bool), "drafted": zeros(torch.bool)}


def quality_buffer(p_sel, q_sel, n_acc, drafted=None):
    """Per-depth quality accumulators from the round's own distributions.

    p_sel/q_sel: (K, B, V) draft/target distributions along the speculated
    chain (or accepted tree path); n_acc: (B,). ``drafted`` marks positions
    whose distributions are genuine drafts (chain: all K; tree: only depths
    at or before the stop, since deeper path entries repeat the stop node).
    Returns {"tvd", "ent": (B, K) float32, "acc", "drafted": (B, K) bool}.
    """
    K, B = p_sel.shape[0], p_sel.shape[1]
    tvd = 0.5 * (p_sel - q_sel).abs().sum(-1).T                     # (B, K)
    ent = -torch.where(q_sel > 0, q_sel * torch.log(q_sel.clamp(min=1e-30)),
                       0.0).sum(-1).T                                 # (B, K)
    acc = torch.arange(K, device=n_acc.device)[None] < n_acc[:, None]
    if drafted is None:
        drafted = torch.ones((B, K), dtype=torch.bool, device=n_acc.device)
    return {"tvd": tvd.float().contiguous(), "ent": ent.float().contiguous(),
            "acc": acc, "drafted": drafted}


def _pick(noise, name, i=None):
    if noise is None:
        return None
    return noise[name] if i is None else noise[name][i]


def sync(device) -> None:
    """Wait for the card, so that a host clock read next covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def commit_tokens(tokens, lengths, vals, n_acc, active=None):
    """Write vals[:, :n_acc+1] at lengths .. lengths+n_acc of each row, in
    place; rows with ``active`` False write nothing. Writes past the buffer
    are dropped, as the reference's scatter drops them (a finished row
    keeps running while others catch up)."""
    B, K = vals.shape
    bidx = torch.arange(B, device=tokens.device)[:, None]
    offs = torch.arange(K, device=tokens.device)[None]
    dst = lengths[:, None] + offs
    valid = (offs <= n_acc[:, None]) & (dst < tokens.shape[1])
    if active is not None:
        valid = valid & active[:, None]
    idx = torch.where(valid, dst, tokens.shape[1] - 1)
    tokens[bidx, idx] = torch.where(valid, vals, tokens[bidx, idx])
    return tokens


def sd_draft_phase(draft, sdc: SDConfig, d_params, state, gen, noise=None,
                   target: Model = None, t_params=None):
    """Sample x_1..x_gamma and keep their draft distributions. Returns
    {"x": (g, B), "p_stack": (g+1, B, V) with the bonus slot zeroed,
    "d_cache", "d_snaps": the snapshots after the first gamma feeds of a
    recurrent drafter, else empty}; a head drafter (which needs ``target``
    and ``t_params``) returns no "d_cache"."""
    g = sdc.gamma
    lengths, pending = state["lengths"], state["pending"]
    if is_head_drafter(draft):
        x, p_stack = head_draft_chain(draft, d_params, t_params, target.cfg,
                                      sdc, state["h_feat"], pending, gen,
                                      noise)
        return {"x": x, "p_stack": p_stack}
    d_cache = state["d_cache"]
    page_table = masked_page_table(state)
    rings = (None if attention_only(draft.cfg) else
             ring_layers(draft, d_cache, sdc.long_context))
    xs, ps, snaps = [], [], []
    tok = pending
    for j in range(g + 1):
        logits, d_cache = draft.decode_step(d_params, tok[:, None],
                                            (lengths + j)[:, None], d_cache,
                                            long_context=sdc.long_context,
                                            page_table=page_table)
        if rings is not None and j < g:
            snaps.append(snapshot(d_cache, rings))
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
    return {"x": x, "p_stack": p_stack, "d_cache": d_cache, "d_snaps": snaps}


def sd_verify_phase(target: Model, sdc: SDConfig, t_params, state, draft_out):
    """One target decode over the gamma+1 speculated tokens (a recurrent
    target: one per token, ``_verify_by_feeds``). Returns {"q_stack": (g+1,
    B, V), "t_cache"}, "t_snaps" for a recurrent target, and "t_hid" (B,
    g+1, D) after a head drafter's draft phase (its output holds no
    "d_cache")."""
    g = sdc.gamma
    lengths, pending = state["lengths"], state["pending"]
    head = "d_cache" not in draft_out
    feed = torch.cat([pending[:, None], draft_out["x"].T], dim=1)   # (B, g+1)
    positions = lengths[:, None] + torch.arange(g + 1, device=lengths.device)
    if not attention_only(target.cfg):
        return _verify_by_feeds(target, sdc, t_params, state["t_cache"],
                                feed, positions, head)
    out = target.decode_step(t_params, feed, positions, state["t_cache"],
                             long_context=sdc.long_context,
                             page_table=masked_page_table(state),
                             return_hidden=head)
    q_stack = probs_from_logits(out[0], sdc.temperature, sdc.top_p)
    verify_out = {"q_stack": q_stack.transpose(0, 1), "t_cache": out[1]}
    if head:
        verify_out["t_hid"] = out[2]
    return verify_out


def _verify_by_feeds(target: Model, sdc: SDConfig, t_params, t_cache, feed,
                     positions, head: bool):
    """A recurrent target's verify: the gamma+1 tokens one decode call
    each, with a snapshot after each of the first gamma ("t_snaps"); with
    a head drafter the hidden states of the feeds, stacked ("t_hid")."""
    g = feed.shape[1] - 1
    rings = ring_layers(target, t_cache, sdc.long_context)
    qs, hs, snaps = [], [], []
    for j in range(g + 1):
        out = target.decode_step(t_params, feed[:, j:j + 1],
                                 positions[:, j:j + 1], t_cache,
                                 long_context=sdc.long_context,
                                 return_hidden=head)
        t_cache = out[1]
        if j < g:
            snaps.append(snapshot(t_cache, rings))
        qs.append(probs_from_logits(out[0][:, 0], sdc.temperature, sdc.top_p))
        if head:
            hs.append(out[2][:, 0])
    verify_out = {"q_stack": torch.stack(qs), "t_cache": t_cache,
                  "t_snaps": snaps}
    if head:
        verify_out["t_hid"] = torch.stack(hs, 1)                  # (B, g+1, D)
    return verify_out


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
    tokens = commit_tokens(tokens, lengths, feed, n_acc, state.get("active"))
    limit = lengths + n_acc                 # keep cache positions <= limit
    new_state = {"tokens": tokens, "lengths": lengths + n_acc + 1,
                 "pending": new_pending,
                 "t_cache": rewind_cache(state, select_snapshot(
                     verify_out["t_cache"], verify_out.get("t_snaps"), n_acc),
                     limit)}
    if sdc.quality:
        # every chain position is a genuine draft: the drafted mask is all
        # ones
        new_state["qual"] = quality_buffer(p_stack[:g], q_stack[:g], n_acc)
    if "t_hid" in verify_out:
        # the feature at the last committed position L + n_acc: verify
        # slot j sits at position L + j
        new_state["h_feat"] = verify_out["t_hid"][bidx, n_acc]
    else:
        new_state["d_cache"] = rewind_cache(state, select_snapshot(
            draft_out["d_cache"], draft_out["d_snaps"], n_acc), limit)
    return gate_rows(state, new_state), n_acc


def sd_round(draft, target: Model, sdc: SDConfig, d_params, t_params,
             state, gen, noise=None):
    """One speculative block. ``draft`` is a drafter ``Model`` (state:
    {tokens, lengths, pending, d_cache, t_cache}) or a ``HeadDrafter``
    (``h_feat`` in place of ``d_cache``); optionally {active, page_table}
    (continuous batching). The caches are updated in place. Returns
    (new_state, n_acc); n_acc of an inactive row is meaningless."""
    draft_out = sd_draft_phase(draft, sdc, d_params, state, gen, noise,
                               target, t_params)
    verify_out = sd_verify_phase(target, sdc, t_params, state, draft_out)
    return sd_commit_phase(sdc, state, draft_out, verify_out, gen, noise)


def _prefill_state(draft, target: Model, d_params, t_params, prompt,
                   max_total, sdc: SDConfig, gen, noise=None):
    """Prefill both models and sample the first pending token (``noise``:
    its (B, V) Gumbel noise). With ``sdc.kv_quant`` the caches are then
    converted to the int8 layout; chain and tree rounds share this. A head
    drafter has no cache: the target's hidden state at the last prompt
    position seeds ``h_feat``."""
    B, S = prompt.shape
    head = is_head_drafter(draft)
    out = target.prefill(t_params, prompt, cache_len=max_total,
                         long_context=sdc.long_context, return_hidden=head)
    lg_t, t_cache = out[0], out[1]
    state = {"t_cache": quantize_kv_cache(t_cache) if sdc.kv_quant else t_cache}
    if head:
        state["h_feat"] = out[2][:, -1]
    else:
        _, d_cache = draft.prefill(d_params, prompt, cache_len=max_total,
                                   long_context=sdc.long_context)
        state["d_cache"] = quantize_kv_cache(d_cache) if sdc.kv_quant else d_cache
    q0 = probs_from_logits(lg_t[:, 0], sdc.temperature, sdc.top_p)
    tokens = torch.zeros((B, max_total + sdc.gamma + 2), dtype=torch.long,
                         device=prompt.device)
    tokens[:, :S] = prompt
    state.update(tokens=tokens, pending=sample_from_probs(q0, gen, noise),
                 lengths=torch.full((B,), S, dtype=torch.long,
                                    device=prompt.device))
    return state


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


def speculative_generate(draft, target: Model, d_params, t_params,
                         prompt, max_new_tokens: int, sdc: SDConfig, gen=None):
    """Generate ``max_new_tokens`` per row with chain speculative decoding.
    ``draft`` is a drafter ``Model`` or a ``HeadDrafter`` (``d_params``:
    its head parameters). prompt: (B, S) int on the models' device.
    Returns (tokens, stats); stats count only rounds in which a row was
    still active."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    B, S = prompt.shape
    max_total = S + max_new_tokens + sdc.gamma + 2
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           max_total, sdc, gen)
    if sdc.quality:
        state["qual"] = init_quality_buffer(B, sdc.gamma, prompt.device)

    def round_fn(st):
        return sd_round(draft, target, sdc, d_params, t_params, st, gen)

    state, stats = run_rounds(round_fn, state, S, max_new_tokens)
    return state["tokens"], stats


def autoregressive_generate(model: Model, params, prompt, max_new_tokens: int,
                            temperature: float = 1.0, top_p: float = 1.0,
                            gen=None, long_context: bool = False):
    """Plain AR decoding baseline (one token per model call). Returns
    (tokens (B, S + max_new), decode wall time in seconds)."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    B, S = prompt.shape
    lg, cache = model.prefill(params, prompt, cache_len=S + max_new_tokens + 1,
                              long_context=long_context)
    toks = [prompt]
    cur = sample_from_probs(probs_from_logits(lg[:, 0], temperature, top_p), gen)
    t0 = time.perf_counter()
    for i in range(max_new_tokens):
        toks.append(cur[:, None])
        if i == max_new_tokens - 1:
            break
        pos = torch.full((B, 1), S + i, dtype=torch.long, device=prompt.device)
        lg, cache = model.decode_step(params, cur[:, None], pos, cache,
                                      long_context=long_context)
        cur = sample_from_probs(probs_from_logits(lg[:, 0], temperature, top_p),
                                gen)
    out = torch.cat(toks, dim=1)
    sync(prompt.device)
    return out, time.perf_counter() - t0

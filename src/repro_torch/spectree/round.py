"""Tree-structured speculative decoding round (``repro.spectree.round``,
with a drafter model: dense per-row caches, or the shared paged pool of
continuous serving, with the ``active``/``page_table`` state keys of
``core.speculative.sd_round``).

  draft  : level-by-level expansion. At each level the drafter scores all
           of the level's nodes in ONE decode call (siblings share RoPE
           position L+depth, occupy slots L+node_index, and attend under
           the ancestor mask), then samples ``branching[d]`` children per
           node i.i.d. from the node's draft distribution.
  verify : the target scores ALL N nodes in ONE decode call under the full
           ancestor mask -> q_u per node.
  accept : recursive rejection sampling down the tree: child j of the
           accepted node u is accepted w.p. min(1, res(t_j)/p_u(t_j)),
           where res starts at q_u and becomes norm(max(res - p_u, 0)) after
           each rejected sibling. If no child survives, the next pending
           token is drawn from the final residual; at an accepted leaf it is
           drawn from q_leaf (the bonus token).
  commit : the accepted root path's K/V is copied from its tree slots to
           the canonical slots L..L+n_acc; every other tree slot is
           invalidated (pos = -1). In a paged pool a storage position maps
           to a page through the row's page table; masked-out rows write
           to the null page.

Every tree-masked decode call goes through the tree attention kernel, so
one round launches it (depth+1) * drafter layers + target layers times.

A round may take a ``noise`` dict with the reference's draws from its
round key: {"draft": [per level (B, n_d, k_d, V) Gumbel], "u": [per depth
(k_d, B) uniforms], "stop": (depth, B, V) Gumbel, "bonus": (B, V) Gumbel}.
"""
from __future__ import annotations

import torch

from ..core.sampling import probs_from_logits, sample_from_probs
from ..core.speculative import (SDConfig, _pick, _prefill_state,
                                attention_only, commit_tokens, gate_rows,
                                masked_page_table, run_rounds)
from ..models.model import Model
from .tree import TreeSpec, tree_attn_mask


def _cache_view_width(cache, page_table=None) -> int:
    """Slot count of the attention view the masks must align with: a dense
    cache's width (the same in every layer), or a paged row's gathered view
    of max_pages * page slots."""
    if page_table is not None:
        return page_table.shape[1] * cache[0]["page_pos"].shape[1]
    return cache[0]["pos"].shape[1]


def commit_tree_path(cache, lengths, path_nodes, n_acc, num_nodes):
    """Dense-cache root-path commit and tree-region invalidation, in place.

    path_nodes: (B, depth+1) node index of the accepted path at each depth
    (entries past n_acc repeat the last node; they get pos -1). Node i's
    K/V sits at slot ``(lengths + i) % Smax``; the accepted depth-d node is
    copied to slot ``(lengths + d) % Smax`` with position ``lengths + d``;
    an int8 cache's per-slot scales move with their entries.
    """
    B, Dp1 = path_nodes.shape
    S = _cache_view_width(cache)
    dev = lengths.device
    offs = torch.arange(Dp1, device=dev)[None]
    bidx = torch.arange(B, device=dev)[:, None]
    src = (lengths[:, None] + path_nodes) % S
    dst = (lengths[:, None] + offs) % S
    tree_slots = (lengths[:, None] + torch.arange(num_nodes, device=dev)[None]) % S
    canon = torch.where(offs <= n_acc[:, None], lengths[:, None] + offs,
                        -1).to(torch.int32)
    for layer in cache:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in layer:
                layer[name][bidx, dst] = layer[name][bidx, src]
        layer["pos"][bidx, tree_slots] = -1
        layer["pos"][bidx, dst] = canon
    return cache


def commit_tree_path_paged(cache, page_table, lengths, path_nodes, n_acc,
                           num_nodes):
    """Paged-pool root-path commit and tree-region invalidation, in place.

    The same commit as ``commit_tree_path`` with storage position s of a row
    at (page_table[row, s // page], s % page). Every source is gathered
    before any destination is written (the reference's scatter is
    functional). Rows masked to the null page route every access to page 0,
    which is never read. Only storage positions >= the committed length are
    addressed, so prefix-shared pages are never touched."""
    page = cache[0]["page_pos"].shape[1]
    table = page_table.long()
    max_pages = table.shape[1]
    dev = lengths.device
    offs = torch.arange(path_nodes.shape[1], device=dev)[None]

    def phys_off(storage):                         # (B, X) absolute positions
        pidx = (storage // page).clamp(0, max_pages - 1)
        return table.gather(1, pidx), storage % page

    src_p, src_o = phys_off(lengths[:, None] + path_nodes)
    dst_p, dst_o = phys_off(lengths[:, None] + offs)
    tree_p, tree_o = phys_off(lengths[:, None]
                              + torch.arange(num_nodes, device=dev)[None])
    canon = torch.where(offs <= n_acc[:, None], lengths[:, None] + offs,
                        -1).to(torch.int32)
    for layer in cache:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in layer:
                layer[name][dst_p, dst_o] = layer[name][src_p, src_o]
        layer["page_pos"][tree_p, tree_o] = -1
        layer["page_pos"][dst_p, dst_o] = canon
    return cache


def commit_path(state, cache, path_nodes, n_acc, num_nodes):
    """Root-path commit of one model's cache, dense or paged."""
    page_table = masked_page_table(state)
    if page_table is None:
        return commit_tree_path(cache, state["lengths"], path_nodes, n_acc,
                                num_nodes)
    return commit_tree_path_paged(cache, page_table, state["lengths"],
                                  path_nodes, n_acc, num_nodes)


def tree_draft_phase(draft: Model, sdc: SDConfig, spec: TreeSpec, d_params,
                     state, gen, noise=None):
    """Level-by-level tree expansion. Returns {"node_tok": (N, B),
    "p_node": (N, B, V), "d_cache"}."""
    if not attention_only(draft.cfg):
        raise ValueError("tree speculative decoding requires an "
                         "attention-only drafter (per-node cache slots)")
    lengths, pending = state["lengths"], state["pending"]
    d_cache = state["d_cache"]
    B = pending.shape[0]
    dev = pending.device
    starts = spec.level_starts
    page_table = masked_page_table(state)
    width = _cache_view_width(d_cache, page_table)
    level_toks = [pending[:, None]]            # level d -> (B, n_d) tokens
    ps = []                                    # per level (n_d, B, V)
    for d in range(spec.depth + 1):
        s, e = starts[d], starts[d + 1]
        nl = e - s
        rope = (lengths + d)[:, None].expand(B, nl)
        slot_pos = lengths[:, None] + torch.arange(s, e, device=dev)[None]
        amask = tree_attn_mask(spec, s, e, lengths, width)
        logits, d_cache = draft.decode_step(d_params, level_toks[d], rope,
                                            d_cache, slots=slot_pos,
                                            attn_mask=amask,
                                            page_table=page_table)
        p = probs_from_logits(logits, sdc.temperature, sdc.top_p)  # (B,nl,V)
        ps.append(p.transpose(0, 1))
        if d < spec.depth:
            k_d = spec.branching[d]
            children = sample_from_probs(
                p[:, :, None, :].expand(B, nl, k_d, p.shape[-1]), gen,
                _pick(noise, "draft", d))
            level_toks.append(children.reshape(B, nl * k_d))
    return {"node_tok": torch.cat([t.T for t in level_toks], dim=0),
            "p_node": torch.cat(ps, dim=0), "d_cache": d_cache}


def tree_verify_phase(target: Model, sdc: SDConfig, spec: TreeSpec, t_params,
                      state, draft_out):
    """ONE target decode over all N tree nodes under the ancestor mask.
    Returns {"q_node": (N, B, V), "t_cache"}."""
    if not attention_only(target.cfg):
        raise ValueError("tree speculative decoding requires an "
                         "attention-only target (per-node cache slots)")
    lengths = state["lengths"]
    dev = lengths.device
    t_cache = state["t_cache"]
    N = spec.num_nodes
    page_table = masked_page_table(state)
    rope = lengths[:, None] + torch.as_tensor(spec.depths(), device=dev)[None]
    slot_pos = lengths[:, None] + torch.arange(N, device=dev)[None]
    amask = tree_attn_mask(spec, 0, N, lengths,
                           _cache_view_width(t_cache, page_table))
    logits, t_cache = target.decode_step(t_params, draft_out["node_tok"].T,
                                         rope, t_cache, slots=slot_pos,
                                         attn_mask=amask,
                                         page_table=page_table)
    q_node = probs_from_logits(logits, sdc.temperature, sdc.top_p)
    return {"q_node": q_node.transpose(0, 1), "t_cache": t_cache}


def tree_commit_phase(sdc: SDConfig, spec: TreeSpec, state, draft_out,
                      verify_out, gen, noise=None):
    """Recursive-rejection acceptance, token commit and root-path cache
    commit. Returns ``(new_state, n_acc)``."""
    tokens, lengths, pending = state["tokens"], state["lengths"], state["pending"]
    node_tok, p_node = draft_out["node_tok"], draft_out["p_node"]
    q_node = verify_out["q_node"]
    B = pending.shape[0]
    dev = pending.device
    children_tab = torch.as_tensor(spec.children(), device=dev)   # (N, kmax)
    bidx = torch.arange(B, device=dev)
    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    n_acc = torch.zeros((B,), dtype=torch.long, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    new_pending = torch.zeros((B,), dtype=torch.long, device=dev)
    path = [cur]
    for d in range(spec.depth):
        res = q_node[cur, bidx]                                       # (B, V)
        p_cur = p_node[cur, bidx]
        child_base = children_tab[cur]                                # (B, kmax)
        accepted = torch.zeros((B,), dtype=torch.bool, device=dev)
        next_cur = cur
        for j in range(spec.branching[d]):
            cidx = child_base[:, j]
            t = node_tok[cidx, bidx]
            ratio = res[bidx, t] / p_cur[bidx, t].clamp(min=1e-20)
            u = (torch.rand((B,), generator=gen, device=dev) if noise is None
                 else noise["u"][d][j])
            acc_j = alive & ~accepted & (u < ratio)
            next_cur = torch.where(acc_j, cidx, next_cur)
            accepted = accepted | acc_j
            # rows still rejecting: advance the residual past this sibling
            rej = alive & ~accepted
            r = (res - p_cur).clamp(min=0.0)
            mass = r.sum(-1, keepdim=True)
            r = torch.where(mass > 1e-9, r / mass.clamp(min=1e-30), res)
            res = torch.where(rej[:, None], r, res)
        stop = alive & ~accepted
        tok_stop = sample_from_probs(res, gen, _pick(noise, "stop", d))
        new_pending = torch.where(stop, tok_stop, new_pending)
        alive = alive & accepted
        n_acc = n_acc + accepted.long()
        cur = next_cur
        path.append(cur)
    tok_bonus = sample_from_probs(q_node[cur, bidx], gen, _pick(noise, "bonus"))
    new_pending = torch.where(alive, tok_bonus, new_pending)
    path_nodes = torch.stack(path, dim=1)                             # (B, D+1)

    tokens = commit_tokens(tokens, lengths, node_tok[path_nodes, bidx[:, None]],
                           n_acc, state.get("active"))
    N = spec.num_nodes
    new_state = {
        "tokens": tokens, "lengths": lengths + n_acc + 1, "pending": new_pending,
        "d_cache": commit_path(state, draft_out["d_cache"], path_nodes, n_acc, N),
        "t_cache": commit_path(state, verify_out["t_cache"], path_nodes, n_acc,
                               N)}
    return gate_rows(state, new_state), n_acc


def tree_round(draft: Model, target: Model, sdc: SDConfig, spec: TreeSpec,
               d_params, t_params, state, gen, noise=None):
    """One tree-speculative block; same state contract as ``sd_round``.
    Returns (new_state, n_acc) with n_acc = accepted draft tokens."""
    draft_out = tree_draft_phase(draft, sdc, spec, d_params, state, gen, noise)
    verify_out = tree_verify_phase(target, sdc, spec, t_params, state,
                                   draft_out)
    return tree_commit_phase(sdc, spec, state, draft_out, verify_out, gen,
                             noise)


def tree_speculative_generate(draft: Model, target: Model, d_params, t_params,
                              prompt, max_new_tokens: int, sdc: SDConfig,
                              spec: TreeSpec, gen=None):
    """Generate with tree speculation; mirrors ``speculative_generate``.
    The caches hold S + max_new + N + 2 slots, rarely a multiple of any
    tile: the kernel masks the ragged last tile itself."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    S = prompt.shape[1]
    max_total = S + max_new_tokens + spec.num_nodes + 2
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           max_total, sdc, gen)

    def round_fn(st):
        return tree_round(draft, target, sdc, spec, d_params, t_params, st, gen)

    state, stats = run_rounds(round_fn, state, S, max_new_tokens)
    return state["tokens"], stats

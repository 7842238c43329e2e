"""Tree-structured speculative decoding round (``repro.spectree.round``,
with a drafter model or draft heads: dense per-row caches, or the shared
paged pool of continuous serving, with the ``active``/``page_table`` state
keys of ``core.speculative.sd_round``).

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

With a ``draftheads.HeadDrafter`` the draft phase expands the tree from
the target's hidden state ``h_feat`` (``head_draft_tree``) and keeps no
drafter cache; the verify pass returns the nodes' hidden states, and the
commit takes ``h_feat`` from the deepest accepted node (the ancestor mask
makes its hidden state the one a chain forward over its root path gives).

Every tree-masked decode call goes through the tree attention kernel, so
one round launches it (depth+1) * drafter layers + target layers times
with a drafter model, and target layers times with draft heads (the
heads' in-round attention is plain torch, as in the reference).

A round may take a ``noise`` dict with the reference's draws from its
round key: {"draft": [per level (B, n_d, k_d, V) Gumbel], "u": [per depth
(k_d, B) uniforms], "stop": (depth, B, V) Gumbel, "bonus": (B, V) Gumbel}.

With ``SDConfig.quality`` the commit also writes ``state["qual"]`` along
the accepted root path (``core.speculative.quality_buffer``), depth-indexed
like a chain's.
"""
from __future__ import annotations

import torch

from ..core.sampling import probs_from_logits, sample_from_probs
from ..core.speculative import (SDConfig, _pick, _prefill_state,
                                attention_only, commit_tokens, gate_rows,
                                init_quality_buffer, masked_page_table,
                                quality_buffer, run_rounds)
from ..draftheads.drafter import head_draft_tree, is_head_drafter
from ..models.model import Model
from .tree import TreeSpec, tree_attn_mask

#: the reference's refusal of a recurrent drafter or target: a tree needs
#: a cache slot per node, and a recurrent state has one per row
TREE_REFUSAL = ("tree speculative decoding requires attention-only draft "
                "and target (per-node cache slots)")


def _cache_view_width(cache, page_table=None) -> int:
    """Slot count of the attention view the masks must align with: a paged
    row's gathered view of max_pages * page slots, or a dense cache's width,
    which must be the same in every layer (the reference refuses caches of
    mixed widths, window-sized rings beside full ones, with this error)."""
    if page_table is not None:
        return page_table.shape[1] * cache[0]["page_pos"].shape[1]
    widths = {layer["pos"].shape[-1] for layer in cache}
    if len(widths) != 1:
        raise ValueError(
            f"tree decoding needs one uniform attention-cache width, got "
            f"{sorted(widths)} (mixed sliding-window caches are unsupported)")
    return widths.pop()


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
    # a tensor, not the number -1: a Python number written through tensor
    # indices is copied from the host first, which waits for the card
    invalid = canon.new_full((), -1)
    for layer in cache:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in layer:
                layer[name][bidx, dst] = layer[name][bidx, src]
        layer["pos"][bidx, tree_slots] = invalid
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
    invalid = canon.new_full((), -1)         # a tensor: see commit_tree_path
    for layer in cache:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in layer:
                layer[name][dst_p, dst_o] = layer[name][src_p, src_o]
        layer["page_pos"][tree_p, tree_o] = invalid
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


def tree_draft_phase(draft, sdc: SDConfig, spec: TreeSpec, d_params,
                     state, gen, noise=None, target: Model = None,
                     t_params=None):
    """Level-by-level tree expansion. Returns {"node_tok": (N, B),
    "p_node": (N, B, V), "d_cache"}; a head drafter (which needs
    ``target`` and ``t_params``) returns no "d_cache"."""
    head = is_head_drafter(draft)
    if (target is not None and not attention_only(target.cfg)) or \
            (not head and not attention_only(draft.cfg)):
        raise ValueError(TREE_REFUSAL)
    if head:
        node_tok, p_node = head_draft_tree(
            draft, d_params, t_params, target.cfg, sdc, spec, state["h_feat"],
            state["pending"], gen, noise)
        return {"node_tok": node_tok, "p_node": p_node}
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
                                            d_cache,
                                            long_context=sdc.long_context,
                                            slots=slot_pos,
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
    Returns {"q_node": (N, B, V), "t_cache"}, and "t_hid" (B, N, D) after a
    head drafter's draft phase (its output holds no "d_cache")."""
    if not attention_only(target.cfg):
        raise ValueError(TREE_REFUSAL)
    lengths = state["lengths"]
    dev = lengths.device
    t_cache = state["t_cache"]
    N = spec.num_nodes
    page_table = masked_page_table(state)
    rope = lengths[:, None] + spec.on(dev)["depths"][None]
    slot_pos = lengths[:, None] + torch.arange(N, device=dev)[None]
    amask = tree_attn_mask(spec, 0, N, lengths,
                           _cache_view_width(t_cache, page_table))
    head = "d_cache" not in draft_out
    out = target.decode_step(t_params, draft_out["node_tok"].T, rope, t_cache,
                             long_context=sdc.long_context,
                             slots=slot_pos, attn_mask=amask,
                             page_table=page_table, return_hidden=head)
    q_node = probs_from_logits(out[0], sdc.temperature, sdc.top_p)
    verify_out = {"q_node": q_node.transpose(0, 1), "t_cache": out[1]}
    if head:
        verify_out["t_hid"] = out[2]
    return verify_out


def tree_commit_phase(sdc: SDConfig, spec: TreeSpec, state, draft_out,
                      verify_out, gen, noise=None):
    """Recursive-rejection acceptance, token commit and root-path cache
    commit. Returns ``(new_state, n_acc)``."""
    tokens, lengths, pending = state["tokens"], state["lengths"], state["pending"]
    node_tok, p_node = draft_out["node_tok"], draft_out["p_node"]
    q_node = verify_out["q_node"]
    B = pending.shape[0]
    dev = pending.device
    children_tab = spec.on(dev)["children"]                       # (N, kmax)
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
        "t_cache": commit_path(state, verify_out["t_cache"], path_nodes, n_acc,
                               N)}
    if sdc.quality:
        # quality buffer along the accepted path: depth step d accepted the
        # child of path node d against (p, q) at that node. Path entries
        # past the stop repeat the stop node, so only depths <= n_acc are
        # genuine drafts: the drafted mask leaves the repeats out.
        D = spec.depth
        pn = path_nodes[:, :D]                                        # (B, D)
        p_path = p_node[pn, bidx[:, None]].transpose(0, 1)            # (D, B, V)
        q_path = q_node[pn, bidx[:, None]].transpose(0, 1)
        drafted = torch.arange(D, device=dev)[None] <= n_acc[:, None]
        new_state["qual"] = quality_buffer(p_path, q_path, n_acc, drafted)
    if "t_hid" in verify_out:
        # the feature of the deepest accepted node, at position L + n_acc
        new_state["h_feat"] = verify_out["t_hid"][bidx, cur]
    else:
        new_state["d_cache"] = commit_path(state, draft_out["d_cache"],
                                           path_nodes, n_acc, N)
    return gate_rows(state, new_state), n_acc


def tree_round(draft, target: Model, sdc: SDConfig, spec: TreeSpec,
               d_params, t_params, state, gen, noise=None):
    """One tree-speculative block; same state contract as ``sd_round``
    (``draft`` a drafter ``Model`` or a ``HeadDrafter``). Returns
    (new_state, n_acc) with n_acc = accepted draft tokens."""
    draft_out = tree_draft_phase(draft, sdc, spec, d_params, state, gen, noise,
                                 target, t_params)
    verify_out = tree_verify_phase(target, sdc, spec, t_params, state,
                                   draft_out)
    return tree_commit_phase(sdc, spec, state, draft_out, verify_out, gen,
                             noise)


def tree_speculative_generate(draft, target: Model, d_params, t_params,
                              prompt, max_new_tokens: int, sdc: SDConfig,
                              spec: TreeSpec, gen=None):
    """Generate with tree speculation; mirrors ``speculative_generate``.
    The caches hold S + max_new + N + 2 slots, rarely a multiple of any
    tile: the kernel masks the ragged last tile itself."""
    if gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)
    B, S = prompt.shape
    max_total = S + max_new_tokens + spec.num_nodes + 2
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           max_total, sdc, gen)
    if sdc.quality:
        state["qual"] = init_quality_buffer(B, spec.depth, prompt.device)

    def round_fn(st):
        return tree_round(draft, target, sdc, spec, d_params, t_params, st, gen)

    state, stats = run_rounds(round_fn, state, S, max_new_tokens)
    return state["tokens"], stats

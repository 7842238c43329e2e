"""``HeadDrafter``: the draft-head stand-in for a drafter ``Model``
(``repro.draftheads.drafter``).

The rounds (``core.speculative.sd_round``, ``spectree.round.tree_round``)
and both serving engines take a ``HeadDrafter`` wherever they take a
drafter model; ``d_params`` then holds the head parameters. Unlike a
drafter model:

  - drafting reads the target's final hidden state at the last cached
    position (state key ``h_feat``, refreshed by the verify pass and the
    prefill through ``return_hidden``) instead of running a second model;
  - there is no drafter KV cache: no ``d_cache`` state key, no second paged
    pool, nothing to rewind or commit after acceptance;
  - a chain round makes ``gamma`` head calls (a drafter model feeds
    gamma + 1 tokens to keep its cache complete), and Medusa makes one.

Sampling takes the drafter-model rounds' noise: chain (gamma, B, V)
Gumbel, tree per level (B, n_d, k_d, V); without it the draws come from
``gen``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.sampling import probs_from_logits, sample_from_probs
from ..models.model import resolve_device
from .heads import (HeadConfig, eagle_block, eagle_fuse, eagle_logits,
                    init_head_params, medusa_logits)


def is_head_drafter(obj) -> bool:
    return getattr(obj, "is_draft_head", False)


def _noise(noise, i):
    return None if noise is None else noise["draft"][i]


@dataclass(frozen=True)
class HeadDrafter:
    """A draft-head family bound to a target architecture."""

    hc: HeadConfig
    is_draft_head = True          # class attribute: the rounds' duck-typing key

    @property
    def kind(self) -> str:
        return self.hc.kind

    def init(self, seed: int, device="cuda", dtype=None):
        """Seeded head parameters on ``device`` (the card unless "cpu");
        matmul weights in ``dtype``, by default float32 (training); a
        served head passes the target's compute dtype."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_head_params(gen, self.hc, dev, dtype)

    def validate_chain(self, gamma: int):
        if self.kind == "medusa" and gamma > self.hc.num_medusa_heads:
            raise ValueError(
                f"medusa chain gamma {gamma} exceeds num_medusa_heads "
                f"{self.hc.num_medusa_heads} (head k drafts position +k)")

    def validate_tree(self, depth: int):
        if self.kind == "medusa" and depth > self.hc.num_medusa_heads:
            raise ValueError(
                f"medusa tree depth {depth} exceeds num_medusa_heads "
                f"{self.hc.num_medusa_heads} (level d draws from head d+1)")


def head_draft_chain(drafter: HeadDrafter, hp, t_params, t_cfg, sdc, h_feat,
                     pending, gen=None, noise=None):
    """Draft gamma tokens from the heads. h_feat: (B, D) target hidden at
    the last cached position (one before ``pending``); pending: (B,) the
    round's root token. Returns (x (g, B), p_stack (g+1, B, V)) with the
    bonus slot zero (its residual is q)."""
    hc, g = drafter.hc, sdc.gamma
    B, V = pending.shape[0], t_cfg.vocab_size
    drafter.validate_chain(g)
    dev = pending.device
    p_stack = torch.zeros((g + 1, B, V), dtype=torch.float32, device=dev)
    if g == 0:
        return torch.zeros((0, B), dtype=torch.long, device=dev), p_stack
    xs = []
    if drafter.kind == "medusa":
        lg = medusa_logits(hp, t_params, t_cfg, hc, h_feat)        # (B, K, V)
        p_all = probs_from_logits(lg, sdc.temperature, sdc.top_p)
        for j in range(g):                                          # head j+1
            p_stack[j] = p_all[:, j]
            xs.append(sample_from_probs(p_all[:, j], gen, _noise(noise, j)))
    else:
        feat, tok = h_feat, pending
        hist = h_feat.new_zeros((B, 0, hc.d_model))
        for j in range(g):
            x = eagle_fuse(hp, t_params, feat[:, None], tok[:, None])
            mask = torch.ones((B, 1, hist.shape[1] + 1), dtype=torch.bool,
                              device=dev)                           # chain: all
            gfeat = eagle_block(hp, hc, x, hist, mask)
            hist = torch.cat([hist, x], dim=1)
            lg = eagle_logits(hp, t_params, t_cfg, hc, gfeat)[:, 0]
            p_stack[j] = probs_from_logits(lg, sdc.temperature, sdc.top_p)
            tok = sample_from_probs(p_stack[j], gen, _noise(noise, j))
            xs.append(tok)
            feat = gfeat[:, 0]
    return torch.stack(xs), p_stack


def head_draft_tree(drafter: HeadDrafter, hp, t_params, t_cfg, sdc, spec,
                    h_feat, pending, gen=None, noise=None):
    """Level-by-level tree expansion from the heads. Returns (node_tok
    (N, B) in flattened level order, root = ``pending``; p_node (N, B, V),
    the distribution each node's children were drawn from; leaves get a
    uniform placeholder that acceptance never reads)."""
    hc, D = drafter.hc, spec.depth
    B, V = pending.shape[0], t_cfg.vocab_size
    drafter.validate_tree(D)
    dev = pending.device
    starts = spec.level_starts
    level_toks = [pending[:, None]]              # level d -> (B, n_d)
    ps = []                                      # level d -> (n_d, B, V)

    def expand(d, p):
        k_d = spec.branching[d]
        children = sample_from_probs(
            p[:, :, None, :].expand(B, p.shape[1], k_d, V), gen, _noise(noise, d))
        level_toks.append(children.reshape(B, -1))

    if drafter.kind == "medusa":
        lg = medusa_logits(hp, t_params, t_cfg, hc, h_feat)        # (B, K, V)
        p_heads = probs_from_logits(lg, sdc.temperature, sdc.top_p)
        for d in range(D + 1):
            nl = starts[d + 1] - starts[d]
            if d < D:                            # level d draws head d+1
                p = p_heads[:, d][:, None].expand(B, nl, V)
                expand(d, p)
            else:                                # leaves: never sampled from
                p = torch.full((B, nl, V), 1.0 / V, dtype=torch.float32,
                               device=dev)
            ps.append(p.transpose(0, 1))
    else:
        # the fused-input buffer grows level by level; a level's queries
        # attend their ancestors' fused inputs (self included)
        anc = spec.on(dev)["ancestors"]
        xbuf = h_feat.new_zeros((B, 0, hc.d_model))
        feat_par = h_feat[:, None]               # (B, 1, D): the root's parent
        for d in range(D + 1):
            s, e = starts[d], starts[d + 1]
            x = eagle_fuse(hp, t_params, feat_par, level_toks[d])   # (B, nl, D)
            gfeat = eagle_block(hp, hc, x, xbuf, anc[s:e, :e][None].expand(B, -1, -1))
            xbuf = torch.cat([xbuf, x], dim=1)
            lg = eagle_logits(hp, t_params, t_cfg, hc, gfeat)       # (B, nl, V)
            p = probs_from_logits(lg, sdc.temperature, sdc.top_p)
            ps.append(p.transpose(0, 1))
            if d < D:
                expand(d, p)
                # each child's parent feature is its parent's block output
                feat_par = gfeat.repeat_interleave(spec.branching[d], dim=1)
    node_tok = torch.cat([t.T for t in level_toks], dim=0)          # (N, B)
    return node_tok, torch.cat(ps, dim=0)

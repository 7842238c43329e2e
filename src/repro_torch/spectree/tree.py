"""Static token-tree topology for tree-structured speculative decoding
(``repro.spectree.tree``).

A draft tree is given by its per-level ``branching``: level 0 is the
single root (the round's pending token) and every node at level d has
``branching[d]`` children, so the flattened buffer holds
``N = sum(prod(branching[:d]))`` nodes in level order. Node i's KV lands
at cache slot ``L + i`` (L = committed length) while its RoPE position is
``L + depth[i]``: siblings share a position but never a slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TreeSpec:
    """Per-level branching of a static draft tree, e.g. (2, 2) = binary
    depth-2 tree with 7 nodes; (1,) * gamma = a chain of gamma drafts."""

    branching: Tuple[int, ...] = (2, 2)

    def __post_init__(self):
        if len(self.branching) < 1:
            raise ValueError("tree needs at least one level of children")
        if any(int(k) < 1 for k in self.branching):
            raise ValueError(f"branching factors must be >= 1: {self.branching}")
        object.__setattr__(self, "branching",
                           tuple(int(k) for k in self.branching))

    @property
    def depth(self) -> int:
        """Levels below the root: the most draft tokens a round accepts."""
        return len(self.branching)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        sizes = [1]
        for k in self.branching:
            sizes.append(sizes[-1] * k)
        return tuple(sizes)

    @property
    def level_starts(self) -> Tuple[int, ...]:
        starts = [0]
        for s in self.level_sizes:
            starts.append(starts[-1] + s)
        return tuple(starts)

    @property
    def num_nodes(self) -> int:
        return self.level_starts[-1]

    @property
    def num_draft_nodes(self) -> int:
        return self.num_nodes - 1

    def parents(self) -> np.ndarray:
        """(N,) flattened parent index; the root's parent is -1."""
        par = np.full((self.num_nodes,), -1, np.int64)
        starts = self.level_starts
        for d, k in enumerate(self.branching):
            for u in range(self.level_sizes[d]):
                for j in range(k):
                    par[starts[d + 1] + u * k + j] = starts[d] + u
        return par

    def depths(self) -> np.ndarray:
        """(N,) level of each node."""
        dep = np.zeros((self.num_nodes,), np.int64)
        starts = self.level_starts
        for d in range(1, self.depth + 1):
            dep[starts[d]:starts[d + 1]] = d
        return dep

    def children(self) -> np.ndarray:
        """(N, max_branch) children table, -1 padded."""
        ch = np.full((self.num_nodes, max(self.branching)), -1, np.int64)
        par = self.parents()
        fill = np.zeros((self.num_nodes,), np.int64)
        for i in range(1, self.num_nodes):
            p = par[i]
            ch[p, fill[p]] = i
            fill[p] += 1
        return ch

    def ancestors(self) -> np.ndarray:
        """(N, N) bool: ancestors[n, j] == j is on n's root path (incl. n)."""
        N = self.num_nodes
        par = self.parents()
        anc = np.zeros((N, N), bool)
        for n in range(N):
            j = n
            while j >= 0:
                anc[n, j] = True
                j = par[j]
        return anc


def tree_attn_mask(spec: TreeSpec, q_lo: int, q_hi: int, lengths, width: int):
    """Attention mask (B, q_hi-q_lo, width) for tree nodes q_lo..q_hi over
    a ``width``-slot cache (column = position % width). Everything outside
    the round's tree region [L, L+N) is allowed (the attention layer ANDs
    slot validity, which leaves exactly the committed prefix); inside it,
    node n may attend slot L+j iff j is an ancestor of n (self inclusive)."""
    dev = lengths.device
    anc = torch.as_tensor(spec.ancestors()[q_lo:q_hi], device=dev)   # (T, N)
    B, T, N = lengths.shape[0], q_hi - q_lo, spec.num_nodes
    cols = (lengths[:, None] + torch.arange(N, device=dev)[None]) % width
    m = torch.ones((B, T, width), dtype=torch.bool, device=dev)
    b3 = torch.arange(B, device=dev)[:, None, None]
    t3 = torch.arange(T, device=dev)[None, :, None]
    m[b3, t3, cols[:, None, :]] = anc[None].expand(B, T, N)
    return m

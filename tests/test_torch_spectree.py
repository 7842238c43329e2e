"""The port's tree speculation at temperature 0, and its tree topology and
masks, against the reference.

Generated tokens must be identical to ``repro``'s for trees (2, 2) and
(1, 1, 1), and equal to greedy autoregressive decoding. On the reference
side, tree-masked attention runs through the Pallas tree kernel in
interpret mode, as on the port's side it runs through the tree attention
wrapper."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import speculative as jspec
from repro.models import attention as jattn
from repro.spectree import round as jround
from repro.spectree import tree as jtree
from repro_torch.core import speculative as tspec
from repro_torch.spectree import round as tround
from repro_torch.spectree import tree as ttree
from torch_parity import MAX_NEW, S, models, tensor  # noqa: F401


@pytest.mark.parametrize("branching", [(2, 2), (1, 1, 1)])
def test_temp0_tree_tokens_identical(models, branching, monkeypatch):
    monkeypatch.setattr(jattn, "TREE_FASTPATH", True)
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    prompt = models["prompt"]
    jtok, jstats = jround.tree_speculative_generate(
        jd, jt, jdp, jtp, jnp.asarray(prompt), MAX_NEW,
        jspec.SDConfig(gamma=3, temperature=0.0), jtree.TreeSpec(branching))
    ttok, tstats = tround.tree_speculative_generate(
        td, tt, tdp, ttp, tensor(prompt, torch.long), MAX_NEW,
        tspec.SDConfig(gamma=3, temperature=0.0), ttree.TreeSpec(branching))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.tau == jstats.tau
    assert tstats.depth_acceptance() == jstats.depth_acceptance()
    tar, _ = tspec.autoregressive_generate(tt, ttp, tensor(prompt, torch.long),
                                           MAX_NEW, temperature=0.0)
    assert torch.equal(ttok[:, :S + MAX_NEW], tar)


@pytest.mark.parametrize("branching", [(2, 2), (3, 1, 2), (1, 1, 1)])
def test_tree_spec_and_mask_match_reference(branching):
    js, ts = jtree.TreeSpec(branching), ttree.TreeSpec(branching)
    assert (ts.num_nodes, ts.depth, ts.level_starts) == (
        js.num_nodes, js.depth, js.level_starts)
    for name in ("parents", "depths", "children", "ancestors"):
        assert np.array_equal(getattr(ts, name)(), getattr(js, name)()), name
    lengths = np.array([5, 29], np.int32)       # the second wraps the ring
    for lo, hi in ((0, ts.num_nodes), (1, ts.level_starts[2])):
        want = jtree.tree_attn_mask(js, lo, hi, jnp.asarray(lengths), 32)
        got = ttree.tree_attn_mask(ts, lo, hi, tensor(lengths, torch.long), 32)
        assert np.array_equal(got.numpy(), np.asarray(want))

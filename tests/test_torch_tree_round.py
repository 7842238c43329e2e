"""One tree-speculative round of the port at temperature 0.7 against the
reference's, given the reference's random draws.

The round is fed the exact Gumbel and uniform noise the reference draws
from its round key; the per-node draft/target distributions must then
agree within 1e-5 (float32, only the order of sums differs), and the
tokens, accept counts and both caches after the root-path commit must be
equal. On the reference side, tree-masked attention runs through the
Pallas tree kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import attention as jattn
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from torch_parity import (B, TOL, check_state, gumbel, models,  # noqa: F401
                          start_states, tensor)


def test_temp07_tree_round_matches_given_reference_noise(models, monkeypatch):
    monkeypatch.setattr(jattn, "TREE_FASTPATH", True)
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    branching = (2, 2)
    jts, tts = JTreeSpec(branching), TTreeSpec(branching)
    k0, kr = jax.random.split(jax.random.PRNGKey(12))
    jsdc, tsdc, jstate, tstate = start_states(models, jts.num_nodes + 2, k0)
    D, V = jts.depth, jt.cfg.vocab_size
    jdr = jround.tree_draft_phase(jd, jt, jsdc, jts, jdp, jtp, jstate, kr)
    jver = jround.tree_verify_phase(jd, jt, jsdc, jts, jtp, jstate, jdr)
    jnew, jn = jround.tree_commit_phase(jd, jt, jsdc, jts, jstate, jdr, jver, kr)
    keys = jax.random.split(kr, 2 * D + sum(branching) + 1)
    sizes = jts.level_sizes
    rest = iter(keys[D:])
    u, stop = [], []
    for d in range(D):
        u.append(tensor(jnp.stack([jax.random.uniform(next(rest), (B,))
                               for _ in range(branching[d])])))
        stop.append(tensor(gumbel(next(rest), (B, V))))
    noise = {"draft": [tensor(gumbel(keys[d], (B, sizes[d], branching[d], V)))
                       for d in range(D)],
             "u": u, "stop": stop, "bonus": tensor(gumbel(next(rest), (B, V)))}
    tdr = tround.tree_draft_phase(td, tsdc, tts, tdp, tstate, None, noise)
    tver = tround.tree_verify_phase(tt, tsdc, tts, ttp, tstate, tdr)
    np.testing.assert_allclose(tdr["p_node"].numpy(), np.asarray(jdr["p_node"]),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tver["q_node"].numpy(), np.asarray(jver["q_node"]),
                               atol=TOL, rtol=0)
    assert np.array_equal(tdr["node_tok"].numpy(), np.asarray(jdr["node_tok"]))
    tnew, tn = tround.tree_commit_phase(tsdc, tts, tstate, tdr, tver, None, noise)
    check_state(tnew, jnew, tn, jn)

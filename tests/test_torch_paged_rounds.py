"""One paged chain round and one paged tree round of the port at
temperature 0.7 against the reference's, given the reference's random
draws, with the continuous-batching state keys: three rows over one shared
pool (``torch_paged``), rows 0 and 1 active and sharing prefix pages, row 2
inactive with its page-table row masked to the null page.

The round is fed the exact Gumbel and uniform noise the reference draws
from its round key; the active rows' draft/target distributions must agree
within ``TOL`` (1e-5, float32) and their tokens and accept counts must be
equal, the inactive row must stay frozen, and both pools must be equal off
the null page. The pipeline pair runs fp pools, the reduced Llama-2 pair
int8 pools (int8 and fp pools of both pairs are held op by op in
test_torch_paged.py).
"""
import jax
import numpy as np
import pytest

from repro.core import speculative as jspec
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro_torch.core import speculative as tspec
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from torch_paged import (ACTIVE, chain_noise, check_round, prefill_states,
                         tree_noise)
from torch_parity import TOL, models, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INT8_PAIR = "llama2-reduced"
_STATES = {}


@pytest.fixture
def paged(models, request):
    """The two packages' prefilled states (int8 pools for ``INT8_PAIR``),
    built once per pair; the port's pools are updated in place by a round,
    so each test gets a copy."""
    pair = request.node.callspec.params["models"]
    if pair not in _STATES:
        _STATES[pair] = prefill_states(models, kv_quant=pair == INT8_PAIR)
    jst, tst = _STATES[pair]
    return jst, {k: ([{n: a.clone() for n, a in c.items()} for c in v]
                     if isinstance(v, list) else v.clone())
                 for k, v in tst.items()}


def test_temp07_paged_chain_round_matches_given_reference_noise(models, paged):
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    jst, tst = paged
    g, V = 3, jt.cfg.vocab_size
    jsdc = jspec.SDConfig(gamma=g, temperature=0.7)
    tsdc = tspec.SDConfig(gamma=g, temperature=0.7)
    kr = jax.random.PRNGKey(21)
    jdr = jspec.sd_draft_phase(jd, jt, jsdc, jdp, jtp, jst, kr)
    jver = jspec.sd_verify_phase(jd, jt, jsdc, jtp, jst, jdr)
    jnew, jn = jspec.sd_commit_phase(jd, jt, jsdc, jst, jdr, jver, kr)
    noise = chain_noise(kr, g, V)
    tdr = tspec.sd_draft_phase(td, tsdc, tdp, tst, None, noise)
    tver = tspec.sd_verify_phase(tt, tsdc, ttp, tst, tdr)
    np.testing.assert_allclose(tdr["p_stack"].numpy()[:, ACTIVE],
                               np.asarray(jdr["p_stack"])[:, ACTIVE],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tver["q_stack"].numpy()[:, ACTIVE],
                               np.asarray(jver["q_stack"])[:, ACTIVE],
                               atol=TOL, rtol=0)
    assert np.array_equal(tdr["x"].numpy()[:, ACTIVE],
                          np.asarray(jdr["x"])[:, ACTIVE])
    tnew, tn = tspec.sd_commit_phase(tsdc, tst, tdr, tver, None, noise)
    check_round(tnew, jnew, tn, jn)


def test_temp07_paged_tree_round_matches_given_reference_noise(models, paged):
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    jst, tst = paged
    jts, tts = JTreeSpec((2, 2)), TTreeSpec((2, 2))
    V = jt.cfg.vocab_size
    jsdc = jspec.SDConfig(gamma=3, temperature=0.7)
    tsdc = tspec.SDConfig(gamma=3, temperature=0.7)
    kr = jax.random.PRNGKey(22)
    jdr = jround.tree_draft_phase(jd, jt, jsdc, jts, jdp, jtp, jst, kr)
    jver = jround.tree_verify_phase(jd, jt, jsdc, jts, jtp, jst, jdr)
    jnew, jn = jround.tree_commit_phase(jd, jt, jsdc, jts, jst, jdr, jver, kr)
    noise = tree_noise(kr, jts, V)
    tdr = tround.tree_draft_phase(td, tsdc, tts, tdp, tst, None, noise)
    tver = tround.tree_verify_phase(tt, tsdc, tts, ttp, tst, tdr)
    np.testing.assert_allclose(tdr["p_node"].numpy()[:, ACTIVE],
                               np.asarray(jdr["p_node"])[:, ACTIVE],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tver["q_node"].numpy()[:, ACTIVE],
                               np.asarray(jver["q_node"])[:, ACTIVE],
                               atol=TOL, rtol=0)
    assert np.array_equal(tdr["node_tok"].numpy()[:, ACTIVE],
                          np.asarray(jdr["node_tok"])[:, ACTIVE])
    tnew, tn = tround.tree_commit_phase(tsdc, tts, tst, tdr, tver, None, noise)
    check_round(tnew, jnew, tn, jn)

"""The port's chain speculative decoding, sampling and metrics against the
reference (tree rounds: test_torch_spectree.py, test_torch_tree_round.py).

At temperature 0 the generated tokens must be identical to ``repro``'s
(chain and autoregressive). At temperature 0.7 the random draws differ
between the packages, so one chain round is fed the exact Gumbel and
uniform noise the reference draws from its round key; the draft/target
distributions must then agree within 1e-5 (float32, only the order of sums
differs) and the tokens, accept counts and caches must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import metrics as jmetrics
from repro.core import sampling as jsampling
from repro.core import speculative as jspec
from repro_torch.core import metrics as tmetrics
from repro_torch.core import sampling as tsampling
from repro_torch.core import speculative as tspec
from torch_parity import (B, MAX_NEW, S, TOL, check_state, gumbel,  # noqa: F401
                          models, start_states, tensor)


def test_temp0_chain_and_ar_tokens_identical(models):
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    prompt = models["prompt"]
    jtok, jstats = jspec.speculative_generate(
        jd, jt, jdp, jtp, jnp.asarray(prompt), MAX_NEW,
        jspec.SDConfig(gamma=3, temperature=0.0))
    ttok, tstats = tspec.speculative_generate(
        td, tt, tdp, ttp, tensor(prompt, torch.long), MAX_NEW,
        tspec.SDConfig(gamma=3, temperature=0.0))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.tau == jstats.tau and tstats.num_blocks == jstats.num_blocks
    jar, _ = jspec.autoregressive_generate(jt, jtp, jnp.asarray(prompt),
                                           MAX_NEW, temperature=0.0)
    tar, _ = tspec.autoregressive_generate(tt, ttp, tensor(prompt, torch.long),
                                           MAX_NEW, temperature=0.0)
    assert np.array_equal(tar.numpy(), np.asarray(jar))
    # greedy exactness of speculation: chain SD commits the target's tokens
    assert torch.equal(ttok[:, :S + MAX_NEW], tar)


def test_temp07_chain_round_matches_given_reference_noise(models):
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    k0, kr = jax.random.split(jax.random.PRNGKey(11))
    jsdc, tsdc, jstate, tstate = start_states(models, 3 + 2, k0)
    g, V = 3, jt.cfg.vocab_size
    jdr = jspec.sd_draft_phase(jd, jt, jsdc, jdp, jtp, jstate, kr)
    jver = jspec.sd_verify_phase(jd, jt, jsdc, jtp, jstate, jdr)
    jnew, jn = jspec.sd_commit_phase(jd, jt, jsdc, jstate, jdr, jver, kr)
    keys = jax.random.split(kr, g + 2)
    noise = {"draft": tensor(jnp.stack([gumbel(keys[j], (B, V))
                                        for j in range(g)])),
             "u": tensor(jax.random.uniform(keys[g], (g, B))),
             "residual": tensor(gumbel(keys[g + 1], (B, V)))}
    tdr = tspec.sd_draft_phase(td, tsdc, tdp, tstate, None, noise)
    tver = tspec.sd_verify_phase(tt, tsdc, ttp, tstate, tdr)
    np.testing.assert_allclose(tdr["p_stack"].numpy(),
                               np.asarray(jdr["p_stack"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(tver["q_stack"].numpy(),
                               np.asarray(jver["q_stack"]), atol=TOL, rtol=0)
    assert np.array_equal(tdr["x"].numpy(), np.asarray(jdr["x"]))
    tnew, tn = tspec.sd_commit_phase(tsdc, tstate, tdr, tver, None, noise)
    check_state(tnew, jnew, tn, jn)


def test_samplers_match_reference_given_its_noise():
    logits = np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    for temp, top_p in ((0.0, 1.0), (0.7, 1.0), (0.7, 0.9), (1.0, 0.5)):
        jp = jsampling.probs_from_logits(jnp.asarray(logits), temp, top_p)
        tp = tsampling.probs_from_logits(tensor(logits), temp, top_p)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
        g = tensor(gumbel(key, (3, 50)))
        assert np.array_equal(tsampling.sample_from_probs(tp, noise=g).numpy(),
                              np.asarray(jsampling.sample_from_probs(key, jp)))
    q = tsampling.probs_from_logits(tensor(logits), 1.0)
    p = tsampling.probs_from_logits(tensor(logits[::-1]), 1.0)
    jr = jsampling.residual_sample(key, jnp.asarray(q.numpy()),
                                   jnp.asarray(p.numpy()))
    tr = tsampling.residual_sample(q, p, noise=tensor(gumbel(key, (3, 50))))
    assert np.array_equal(tr.numpy(), np.asarray(jr))


def test_top_p_just_below_one_stays_a_distribution():
    """The reference's cutoff index can reach V here and leave all zeros
    (ROADMAP §3); the port clamps it to V - 1."""
    logits = np.random.default_rng(0).standard_normal((3, 20)).astype(np.float32) * 4
    p = tsampling.probs_from_logits(tensor(logits), 1.0, 0.9999999999999999)
    assert torch.isfinite(p).all() and (p >= 0).all()
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)


def test_sd_stats_match_reference():
    rng = np.random.default_rng(2)
    js, ts = jmetrics.SDStats(), tmetrics.SDStats()
    for _ in range(5):
        blocks = rng.integers(1, 5, rng.integers(0, 4))
        js.update_batch(blocks)
        ts.update_batch(blocks)
    assert (ts.tau, ts.accept_hist, ts.depth_hist) == (js.tau, js.accept_hist,
                                                       js.depth_hist)
    assert ts.depth_acceptance() == js.depth_acceptance()
    assert tmetrics.mbsu(2.5, 0.0164, 3) == jmetrics.mbsu(2.5, 0.0164, 3)

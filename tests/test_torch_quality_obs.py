"""The port's speculation-quality telemetry (``SDConfig.quality``, the
round's ``state["qual"]`` buffers, their pooling in the continuous engine)
against the reference's, and the engine's flight recorder and SLO hooks.

``quality_buffer`` and the buffers a chain and a tree round write (dense
and paged, with a drafter model or draft heads, the port fed the
reference's random draws) must match the reference's within ``TOL`` =
1e-5 (float32: only the order of sums differs), the accept and drafted
masks exactly. Quality telemetry draws no random numbers, so with the same
engine generator the tokens must be identical with it on and off, at
temperature 0 and at 0.7. A crash mid-run and an SLO breach must each
leave a parseable post-mortem bundle.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import speculative as jspec
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro_torch import obs as tobs
from repro_torch.core import speculative as tspec
from repro_torch.serving import ContinuousEngine as TEngine
from repro_torch.serving import ServeRequest as TRequest
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from test_torch_draftheads import G as HG                     # noqa: F401
from test_torch_draftheads import heads, target               # noqa: F401
from test_torch_draftheads import prompt as head_prompt
from torch_paged import ACTIVE, chain_noise, prefill_states, tree_noise
from torch_parity import (B, TOL, gumbel, models, one_torch_thread,  # noqa: F401
                          start_states, tensor, tiny_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def check_qual(tq, jq, rows=None):
    """Port and reference quality buffers: TVD and entropy within TOL, the
    masks exactly; ``rows`` selects the rows compared (all by default)."""
    rows = slice(None) if rows is None else rows
    for name in ("tvd", "ent"):
        assert tq[name].dtype == torch.float32
        np.testing.assert_allclose(tq[name].numpy()[rows],
                                   np.asarray(jq[name])[rows], atol=TOL,
                                   rtol=0, err_msg=name)
    for name in ("acc", "drafted"):
        assert np.array_equal(tq[name].numpy()[rows],
                              np.asarray(jq[name])[rows]), name


@pytest.mark.parametrize("shape", ["chain", "tree"])
def test_quality_buffer_matches_reference(shape):
    rng = np.random.default_rng(31)
    K, R, V = 3, 6, 50
    p = jax.nn.softmax(jnp.asarray(rng.normal(size=(K, R, V)) * 3), -1)
    q = np.array(jax.nn.softmax(jnp.asarray(rng.normal(size=(K, R, V)) * 3), -1))
    q[:, 0] = np.eye(V)[rng.integers(0, V, K)]        # temperature 0: one-hot
    n_acc = rng.integers(0, K + 1, R)
    drafted = (np.arange(K)[None] <= n_acc[:, None]) if shape == "tree" else None
    jq = jspec.quality_buffer(jnp.asarray(p, jnp.float32),
                              jnp.asarray(q, jnp.float32),
                              jnp.asarray(n_acc, jnp.int32),
                              None if drafted is None else jnp.asarray(drafted))
    tq = tspec.quality_buffer(tensor(p, torch.float32), tensor(q, torch.float32),
                              tensor(n_acc, torch.long),
                              None if drafted is None else tensor(drafted))
    check_qual(tq, jq)
    assert float(tq["ent"][0].abs().max()) == 0.0      # one-hot: no entropy
    init = tspec.init_quality_buffer(R, K, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in init.items()} == {
        "tvd": ((R, K), torch.float32), "ent": ((R, K), torch.float32),
        "acc": ((R, K), torch.bool), "drafted": ((R, K), torch.bool)}


def _round_pair(how, models, jst, tst, kr, rows):
    """One quality round of each package from the given states, the port
    fed the reference's draws from ``kr``. Returns (port state, reference
    state)."""
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    V = jt.cfg.vocab_size
    jsdc = jspec.SDConfig(gamma=3, temperature=0.7, quality=True)
    tsdc = tspec.SDConfig(gamma=3, temperature=0.7, quality=True)
    if how == "chain":
        jnew, _ = jspec.sd_round(jd, jt, jsdc, jdp, jtp, jst, kr)
        tnew, _ = tspec.sd_round(td, tt, tsdc, tdp, ttp, tst, None,
                                 chain_noise(kr, 3, V, rows))
    else:
        jts = JTreeSpec((2, 2))
        jnew, _ = jround.tree_round(jd, jt, jsdc, jts, jdp, jtp, jst, kr)
        tnew, _ = tround.tree_round(td, tt, tsdc, TTreeSpec((2, 2)), tdp, ttp,
                                    tst, None, tree_noise(kr, jts, V, rows))
    assert np.array_equal(tnew["lengths"].numpy(), np.asarray(jnew["lengths"]))
    return tnew, jnew


@pytest.mark.parametrize("how", ["chain", "tree"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_round_quality_buffer_matches_reference(models, layout, how):
    """``state["qual"]`` of a temperature-0.7 round (dense caches, or the
    paged pool with an inactive row, whose buffer is not compared)."""
    kr = jax.random.PRNGKey(41)
    if layout == "dense":
        k0, kr = jax.random.split(kr)
        _, _, jst, tst = start_states(models, 7 + 2, k0)
        rows, sel = B, None
    else:
        jst, tst = prefill_states(models, kv_quant=False)
        rows, sel = 3, ACTIVE
    tnew, jnew = _round_pair(how, models, jst, tst, kr, rows)
    check_qual(tnew["qual"], jnew["qual"], sel)
    if how == "tree":     # the stop node's repeats are not drafted
        d = tnew["qual"]["drafted"].numpy()
        assert (d[:, 0] & (d[:, :-1] >= d[:, 1:]).all(1)).all()


HEAD_ROUNDS = [(k, r) for k in ("eagle", "medusa") for r in ("chain", "tree")]


@pytest.mark.parametrize("kind,how", HEAD_ROUNDS)
def test_head_round_quality_buffer_matches_reference(target, heads, kind, how):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    V = jt.cfg.vocab_size
    k0, kr = jax.random.split(jax.random.PRNGKey(11))
    toks = head_prompt()
    rows, S = toks.shape
    jsdc = jspec.SDConfig(gamma=HG, temperature=0.7, quality=True)
    tsdc = tspec.SDConfig(gamma=HG, temperature=0.7, quality=True)
    jst = jspec._prefill_state(jh, jt, jhp, jtp, jnp.asarray(toks), S + 8,
                               jsdc, k0)
    tst = tspec._prefill_state(th, tt, thp, ttp, tensor(toks, torch.long),
                               S + 8, tsdc, None,
                               noise=tensor(gumbel(k0, (rows, V))))
    if how == "chain":
        jnew, _ = jspec.sd_round(jh, jt, jsdc, jhp, jtp, jst, kr)
        tnew, _ = tspec.sd_round(th, tt, tsdc, thp, ttp, tst, None,
                                 chain_noise(kr, HG, V, rows))
    else:
        jts = JTreeSpec((2, 2))
        jnew, _ = jround.tree_round(jh, jt, jsdc, jts, jhp, jtp, jst, kr)
        tnew, _ = tround.tree_round(th, tt, tsdc, TTreeSpec((2, 2)), thp, ttp,
                                    tst, None, tree_noise(kr, jts, V, rows))
    assert np.array_equal(tnew["tokens"].numpy(), np.asarray(jnew["tokens"]))
    check_qual(tnew["qual"], jnew["qual"])


# ------------------------------------------------------------ the engine

ENGINE = dict(max_batch=2, max_seq_len=48, page_size=4, prefill_chunk=8)


def _requests():
    rng = np.random.default_rng(0)
    return [TRequest(prompt=rng.integers(0, 64, 10).astype(np.int32),
                     max_new_tokens=6 + i, request_id=i,
                     tenant="even" if i % 2 == 0 else "odd")
            for i in range(3)]


IDENTITY_CASES = {   # name -> (drafter: "model" or head kind, tree, temperature)
    "chain-t0": ("model", None, 0.0),
    "chain-t0.7": ("model", None, 0.7),
    "tree-t0": ("model", (2, 2), 0.0),
    "tree-t0.7": ("model", (2, 2), 0.7),
    "eagle-tree-t0.7": ("eagle", (2, 2), 0.7),
    "medusa-chain-t0.7": ("medusa", None, 0.7),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_engine_tokens_identical_with_quality_on_and_off(tiny_pair, target,
                                                         heads, case):
    kind, tree, temperature = IDENTITY_CASES[case]
    if kind == "model":
        tt, ttp, td, tdp = tiny_pair["t"]
        drafter = dict(draft=td, draft_params=tdp)
    else:
        _, _, tt, ttp = target
        drafter = dict(draft_heads=heads[kind][2], draft_head_params=heads[kind][3])
    out = {}
    for quality in (False, True):
        eng = TEngine(target=tt, target_params=ttp, **drafter,
                      sd=tspec.SDConfig(gamma=3, temperature=temperature),
                      tree=None if tree is None else TTreeSpec(tree),
                      quality=quality, **ENGINE)
        out[quality] = {r.request_id: r.tokens.tolist()
                        for r in eng.serve(_requests())}
    assert out[True] == out[False], "quality telemetry changed the tokens"
    q = eng.quality_stats
    assert eng.sd.quality and q.rounds == eng.telemetry.decode_rounds
    assert q.depth == (2 if tree else 3) and q.attempted.sum() > 0
    assert all(eng.stats[i].quality.rounds > 0 for i in range(3))
    assert set(eng.tenant_quality) == {"even", "odd"}
    assert sum(t.rounds for t in eng.tenant_quality.values()) >= q.rounds
    if tree:              # a tree path stops at its first rejection
        assert all(q.drafted[i] >= q.drafted[i + 1] for i in range(q.depth - 1))


@pytest.mark.parametrize("tree", [None, (2, 2)], ids=["chain", "tree"])
def test_generate_tokens_identical_with_quality_on_and_off(tiny_pair, tree):
    tt, ttp, td, tdp = tiny_pair["t"]
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, 64, (2, 9)))
    toks = []
    for quality in (False, True):
        sdc = tspec.SDConfig(gamma=3, temperature=0.7, quality=quality)
        gen = torch.Generator().manual_seed(7)
        if tree is None:
            out, _ = tspec.speculative_generate(td, tt, tdp, ttp, prompt, 10,
                                                sdc, gen)
        else:
            out, _ = tround.tree_speculative_generate(
                td, tt, tdp, ttp, prompt, 10, sdc, TTreeSpec(tree), gen)
        toks.append(out)
    assert torch.equal(toks[0], toks[1])


def _engine(tiny_pair, **kw):
    tt, ttp, td, tdp = tiny_pair["t"]
    return TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                   sd=tspec.SDConfig(gamma=2, temperature=0.0), **ENGINE, **kw)


def test_engine_crash_dumps_flight_bundle(tiny_pair, tmp_path):
    eng = _engine(tiny_pair, quality=True, flight_record=True,
                  flight_dir=str(tmp_path))
    eng.submit(TRequest(prompt=np.arange(8, dtype=np.int32), max_new_tokens=6,
                        request_id=0))
    stream = eng.stream()
    next(stream)                                   # engine is mid-run
    eng._slots[0].stats = None                     # induce a crash
    with pytest.raises(AttributeError):
        for _ in stream:
            pass
    crash = [p for p in os.listdir(tmp_path) if "crash" in p]
    assert len(crash) == 1
    bundle = json.load(open(tmp_path / crash[0]))
    assert "AttributeError" in bundle["context"]["error"]
    assert "quality" in bundle["context"]


def test_engine_slo_breach_and_round_records(tiny_pair, tmp_path):
    """An unmeetable TTFT SLO breaches at retirement and dumps a bundle;
    the ring holds one record per decode round with accept masks, mean
    TVD and (with ``time_phases``) the phase times."""
    eng = _engine(tiny_pair, quality=True, flight_record=True,
                  flight_dir=str(tmp_path), time_phases=True,
                  slo=tobs.SLOConfig(ttft_ms=1e-6, tpot_ms=1e6))
    eng.serve(_requests())
    tr = eng.slo_tracker
    assert tr.seen == 3 and tr.breaches["ttft"] >= 1 and tr.breaches["tpot"] == 0
    bundles = sorted(p for p in os.listdir(tmp_path) if "slo_breach" in p)
    assert bundles and len(bundles) == len(eng.recorder.dumped_paths)
    bundle = json.load(open(tmp_path / bundles[0]))
    assert bundle["reason"] == "slo_breach"
    assert bundle["context"]["metrics"] == ["ttft"]
    assert bundle["context"]["slo"]["seen"] >= 1
    rec = eng.recorder
    assert rec.rounds_seen == eng.telemetry.decode_rounds
    last = rec.ring[-1]
    assert set(last) >= {"round", "slots", "queue_depth", "free_pages",
                         "active_rows", "phase_s"}
    for s in last["slots"].values():
        assert len(s["accept"]) == 2 and s["committed"] >= 1
        assert s["mean_tvd"] is None or 0.0 <= s["mean_tvd"] <= 1.0
    assert "slo" in tr.summary() and "ttft" in tr.summary()


def test_quality_config_is_a_frozen_field():
    sdc = tspec.SDConfig()
    assert sdc.quality is False
    with pytest.raises(dataclasses.FrozenInstanceError):
        sdc.quality = True

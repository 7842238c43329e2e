"""The port's observability (``repro_torch.obs``) and its hooks in the
continuous engine, against the reference's ``repro.obs``.

The modules copied from the reference (trace, registry, sketch, quality,
recorder, phases, report) must give identical traces, Prometheus text,
JSONL snapshots, sketch quantiles, SLO burn rates, Page–Hinkley alarms,
``QualityStats`` snapshots and recorder bundles for the same event and
observation sequences, drawn from a numpy seed (wall-clock stamps are the
only fields left out). The roofline's draft-phase bytes and the
attribution report must equal the reference's for the 7B pair, the EAGLE
and Medusa heads and the reduced config (pure float arithmetic in the same
order: exact). The engine with every hook on must commit the fused
round's tokens when its phases are fenced one by one, rebuild each
request's TTFT from its trace within 1 ms (the reference's bound), and
account every committed token in its registry; at temperature 0 its
counters must equal the reference engine's, its mean TVD within 1e-5
(float32).
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import metrics as jmetrics
from repro.core import speculative as jspec
from repro.draftheads import HeadConfig as JHeadConfig
from repro.quant import roofline as jroof
from repro.serving import ContinuousEngine as JEngine
from repro.serving import ServeRequest as JRequest
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import metrics as tmetrics
from repro_torch.core import speculative as tspec
from repro_torch.draftheads import HeadConfig as THeadConfig
from repro_torch.obs import phases as tphases
from repro_torch.quant import roofline as troof
from repro_torch.serving import ContinuousEngine as TEngine
from repro_torch.serving import ServeRequest as TRequest
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from torch_parity import TOL, one_torch_thread, tiny_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# ------------------------------------------------------------ copied modules


def _strip(obj, keys=("ts",)):
    """``obj`` without the wall-clock fields ``keys``, at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_strip(v, keys) for v in obj]
    return obj


def _trace_case(M, tmp):
    rng = np.random.default_rng(21)
    tr = M.Tracer()
    for t in np.cumsum(rng.uniform(1e-3, 1e-2, 60)):
        kind, rid = int(rng.integers(0, 5)), int(rng.integers(0, 4))
        if kind == 0:
            tr.async_begin("request", rid, ts=float(t),
                           prompt_tokens=int(rng.integers(1, 64)))
        elif kind == 1:
            tr.async_instant("first_token", rid, ts=float(t))
        elif kind == 2:
            tr.async_end("request", rid, ts=float(t), new_tokens=3, tau=1.5)
        elif kind == 3:
            tr.counter("queue_depth", int(rng.integers(0, 9)), ts=float(t))
        else:
            tr.instant("compact", ts=float(t), pages=int(rng.integers(0, 9)))
    path = tmp / "trace.json"
    tr.write(str(path))
    off = M.Tracer(enabled=False)
    off.async_begin("request", 1)
    off.counter("x", 1)
    return (json.loads(path.read_text()), off.span("a") is off.span("b"),
            off.events(), M.set_tracer(None) is M.NULL_TRACER,
            M.get_tracer().enabled)


def _registry_case(M, tmp):
    rng = np.random.default_rng(22)
    reg = M.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_s", buckets=M.log_buckets(1e-3, 10.0),
                      help="latency")
    acc = reg.histogram("accepted", buckets=(0.0, 1.0, 2.0, 3.0))
    path = tmp / "m.jsonl"
    for i in range(50):
        c.inc(float(rng.integers(0, 3)))
        g.set(float(rng.normal()))
        h.observe(float(rng.pareto(1.5) * 1e-2))
        acc.observe(float(rng.integers(0, 4)))
        if i % 10 == 0:
            reg.write_snapshot(str(path), ts=float(i))
    c.set_total(5.0)                      # monotonic: never lowers
    errors = []
    for bad in (lambda: reg.gauge("reqs_total"), lambda: reg.counter("bad name"),
                lambda: c.inc(-1), lambda: M.Histogram("x", buckets=(2.0, 1.0)),
                lambda: M.log_buckets(0.0, 1.0)):
        try:
            bad()
        except (TypeError, ValueError) as e:
            errors.append(type(e).__name__)
    return reg.to_prometheus(), path.read_text(), errors, "depth" in reg


def _sketch_case(M, tmp):
    rng = np.random.default_rng(23)
    sk = M.GKSketch(eps=0.01)
    for v in rng.pareto(1.2, 3000):
        sk.insert(float(v))
    quantiles = [sk.query(phi) for phi in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)]
    slo = M.SLOTracker(M.SLOConfig(ttft_ms=50.0, tpot_ms=10.0, fast_window=8,
                                   slow_window=32, fast_burn=2.0,
                                   slow_burn=1.5, target=0.9))
    fired = []
    for i in range(120):
        scale = 0.02 if i < 60 else 0.08          # a latency shift half-way
        fired.append(slo.observe(float(rng.exponential(scale)),
                                 float(rng.exponential(scale / 5))))
    return (quantiles, len(sk), sk.n, fired, slo.burn_rates("ttft"),
            slo.burn_rates("tpot"), json.dumps(slo.snapshot()), slo.summary(),
            slo.breached)


def _quality_case(M, tmp):
    rng = np.random.default_rng(24)
    ph = M.PageHinkley()
    x = np.concatenate([rng.binomial(24, 0.85, 80), rng.binomial(24, 0.4, 40),
                        rng.binomial(24, 0.8, 80)]) / 24.0
    alarms = [ph.update(float(v)) for v in x]
    K = 3
    q, other = M.QualityStats(depth=K), M.QualityStats(depth=K)
    q_alarms = []
    for r in range(60):
        R = int(rng.integers(1, 6))
        p_acc = 0.8 if r < 30 else 0.2
        acc = rng.random((R, K)) < p_acc
        drafted = np.cumsum(~acc, 1) <= 1          # a tree path's repeats
        tvd = rng.uniform(0, 1, (R, K)).astype(np.float32)
        ent = rng.choice([0.0, 0.3, 0.7, 1.5, 3.0, 6.0], (R, K)).astype(np.float32)
        q_alarms.append(q.update_round(tvd, ent, acc, drafted))
        other.update_round(tvd[:1], ent[:1], acc[:1])
    reg = M.MetricsRegistry()
    q.emit(reg)
    merged = M.QualityStats(depth=K).merge(q).merge(other)
    rep = M.acceptance_report(q, K)
    return (alarms, ph.alarms, q_alarms, json.dumps(q.snapshot()), q.summary(),
            reg.to_prometheus(), json.dumps(merged.snapshot()),
            q.acceptance_entropy_curve(), json.dumps(rep),
            M.format_acceptance_report(rep), list(M.ENTROPY_BINS))


def _recorder_case(M, tmp):
    rng = np.random.default_rng(25)
    out_dir = tmp / "flight"
    rec = M.FlightRecorder(out_dir=str(out_dir), capacity=4, max_dumps=2)
    for i in range(10):
        rec.record_round(slots={0: {"committed": int(rng.integers(1, 4))}},
                         tvd=np.float32(rng.uniform()),
                         mask=rng.random(3) < 0.5, phase_s={"draft": 0.01 * i})
    paths = [rec.dump("drift_alarm", context={"ewma": float("nan"),
                                              "acc": np.array([1, 2])}),
             rec.dump("slo_breach"), rec.dump("crash")]
    bundles = [_strip(json.loads(open(p).read())) for p in paths if p]
    return ([None if p is None else p.rsplit("/", 1)[1] for p in paths],
            bundles, rec.rounds_seen, len(rec.ring),
            [_strip(t) for t in rec.triggers])


def _phases_case(M, tmp):
    rng = np.random.default_rng(26)
    pt = M.PhaseTimer()
    for _ in range(20):
        dts = rng.uniform(1e-3, 1e-2, 4)
        for name, dt in zip(("draft", "verify", "commit", "prefill"), dts):
            pt.add(name, float(dt))
        pt.add_step(float(dts.sum() + rng.uniform(0, 5e-3)))
    return (pt.breakdown(), pt.fractions(), pt.summary(), pt.host_s,
            M.PhaseTimer().summary())


def _sd_stats_case(M, tmp):
    metrics, obs = M
    rng = np.random.default_rng(27)
    s = metrics.SDStats()
    for n in rng.integers(1, 5, 40):
        s.update(int(n))
    reg = obs.MetricsRegistry()
    s.emit(reg)
    s.emit(reg, prefix="sd_pooled")
    return (reg.to_prometheus(), s.tau, s.mbsu(0.0174, 3),
            metrics.block_efficiency(17, 4), metrics.token_rate_ratio(90.0, 45.0),
            metrics.latency_percentiles(obs.GKSketch()))


HOST_CASES = {
    "trace": _trace_case, "registry": _registry_case, "sketch": _sketch_case,
    "quality": _quality_case, "recorder": _recorder_case,
    "phases": _phases_case, "sd-stats-emit": _sd_stats_case,
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_copied_host_modules_match_reference(case, tmp_path):
    sides = {"j": (jmetrics, jobs), "t": (tmetrics, tobs)}
    got = {}
    for side, mods in sides.items():
        (tmp_path / side).mkdir()
        got[side] = HOST_CASES[case](mods if case == "sd-stats-emit"
                                     else mods[1], tmp_path / side)
    assert json.dumps(got["t"], default=str) == json.dumps(got["j"], default=str)


# ------------------------------------------------------------ roofline, report

ROOF_CASES = {   # name -> (arch, reduced, drafter kind: "model" or head kind)
    "7b-drafter": ("llama2-7b-chat", False, "model"),
    "7b-eagle": ("llama2-7b-chat", False, "eagle"),
    "7b-medusa": ("llama2-7b-chat", False, "medusa"),
    "reduced-drafter": ("llama2-7b-chat", True, "model"),
    "reduced-eagle": ("llama2-7b-chat", True, "eagle"),
}


def _roofline_rows(cfgs, roof, obs, head_cls, arch, small, kind):
    get_config, reduced = cfgs
    tcfg = get_config(arch)
    if small:
        tcfg = reduced(tcfg)
    drafter = (tcfg.drafter().replace(vocab_size=tcfg.vocab_size)
               if kind == "model" else head_cls.for_target(kind, tcfg))
    rows = []
    for weights in ("float32", "bfloat16", "int8", "int4"):
        for kv in ("bfloat16", "int8"):
            for gamma, batch, ctx in ((3, 4, 192), (2, 8, 64)):
                if kind == "model":
                    b = roof.drafter_round_bytes(drafter, batch, ctx, gamma,
                                                 weights, kv)
                else:
                    b = roof.head_round_bytes(drafter, tcfg, batch, ctx, gamma,
                                              weights)
                rows.append((weights, kv, gamma, b.row(),
                             roof.decode_step_bytes(tcfg, batch, ctx, weights,
                                                    kv).row()))
    timer = obs.PhaseTimer()
    for i in range(6):
        timer.add("draft", 0.004 + 1e-4 * i)
        timer.add("verify", 0.011 + 2e-4 * i)
        timer.add("commit", 0.002)
        timer.add_step(0.02 + 1e-4 * i)
    rep = obs.attribution_report(timer, tcfg, drafter, batch=8, ctx=96,
                                 gamma=2, weights="int8", kv="int8",
                                 peak_gbps=3350.0)
    return rows, rep, obs.format_attribution(rep)


@pytest.mark.parametrize("case", sorted(ROOF_CASES))
def test_round_bytes_and_attribution_match_reference(case):
    arch, small, kind = ROOF_CASES[case]
    want = _roofline_rows((jget_config, jreduced), jroof, jobs, JHeadConfig,
                          arch, small, kind)
    got = _roofline_rows((tget_config, treduced), troof, tobs, THeadConfig,
                         arch, small, kind)
    assert got == want
    assert set(got[1]["phases"]) == {"draft", "verify"}


# ------------------------------------------------------------ torch_profile

def test_torch_profile_writes_a_trace_and_is_a_noop_without_a_dir(tmp_path):
    with tobs.torch_profile(None):
        torch.ones(3).sum()
    with tobs.torch_profile(""):
        pass
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "prof"
    with tobs.torch_profile(str(out)):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    doc = json.loads((out / tphases.TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


def test_torch_profile_raises_when_the_profiler_cannot_start(tmp_path,
                                                             monkeypatch):
    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with tobs.torch_profile(str(tmp_path / "p")):
            pass


def test_torch_profile_exports_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with tobs.torch_profile(str(tmp_path)):
            torch.ones(2).sum()
            raise ValueError("mid-run")
    assert (tmp_path / tphases.TRACE_FILE).stat().st_size > 0


# ------------------------------------------------------------ engine hooks

LENS, NEW = (6, 10, 8), (8, 6, 7)
ENGINE = dict(max_batch=2, max_seq_len=32, page_size=4, prefill_chunk=8)


def _requests(cls, tenants=False):
    rng = np.random.default_rng(3)
    return [cls(prompt=rng.integers(0, 64, n).astype(np.int32),
                max_new_tokens=m, request_id=i,
                tenant=("even" if i % 2 == 0 else "odd") if tenants else "")
            for i, (n, m) in enumerate(zip(LENS, NEW))]


def _port_engine(tiny_pair, tree, temperature, **kw):
    tt, ttp, td, tdp = tiny_pair["t"]
    return TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                   sd=tspec.SDConfig(gamma=2, temperature=temperature),
                   tree=None if tree is None else TTreeSpec(tree), **ENGINE,
                   **kw)


def ttft_from_trace(events):
    """{request id: TTFT s} from the request tracks' ``b`` and
    ``first_token`` events (microseconds)."""
    begin = {e["id"]: e["ts"] for e in events if e["ph"] == "b"}
    first = {e["id"]: e["ts"] for e in events
             if e["ph"] == "n" and e["name"] == "first_token"}
    assert set(begin) == set(first)
    return {rid: (first[rid] - begin[rid]) / 1e6 for rid in begin}


@pytest.mark.parametrize("tree", [None, (2, 2)], ids=["chain", "tree"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_engine_trace_phases_registry_and_fused_equivalence(
        tiny_pair, tree, temperature, tmp_path):
    """Every hook on, ``time_phases`` included: the phase-by-phase round
    commits the fused round's tokens (the same generator draws), the trace
    rebuilds every TTFT within 1 ms, the phase split sums to the step time,
    and the registry accounts every committed token."""
    fused = _port_engine(tiny_pair, tree, temperature).serve(_requests(TRequest))
    tracer, registry = tobs.Tracer(), tobs.MetricsRegistry()
    eng = _port_engine(tiny_pair, tree, temperature, tracer=tracer,
                       registry=registry, time_phases=True,
                       metrics_out=str(tmp_path / "m.jsonl"), metrics_every=3)
    phased = eng.serve(_requests(TRequest))
    for a, b in zip(fused, phased):
        assert a.request_id == b.request_id
        assert np.array_equal(a.tokens, b.tokens), a.request_id

    evs = tracer.events()
    for rid, ttft in ttft_from_trace(evs).items():
        assert abs(ttft - eng.stats[rid].ttft_s) < 1e-3
    assert {"request", "admit", "first_token", "decode_round", "prefill_chunk",
            "draft", "verify", "commit", "queue_depth", "active_rows",
            "free_pages"} <= {e["name"] for e in evs}
    assert len([e for e in evs if e["ph"] == "e"]) == len(LENS)

    bd = eng.phases.breakdown()
    assert {"draft", "verify", "commit", "prefill", "host"} == set(bd)
    assert sum(bd.values()) == pytest.approx(eng.phases.total_s, rel=1e-6)
    assert eng.phases.counts["verify"] == eng.telemetry.decode_rounds
    assert eng.phase_device_ms == {}      # no card: device spans not measured

    stats = list(eng.stats.values())
    assert registry.counter("sd_tokens_total").value == \
        sum(s.sd.total_tokens for s in stats)
    assert registry.counter("sd_blocks_total").value == \
        sum(s.sd.num_blocks for s in stats)
    assert registry.histogram("sd_accepted_per_round").count == \
        sum(s.sd.num_blocks for s in stats)
    assert sum(s.sd.total_tokens for s in stats) >= sum(NEW)
    assert registry.counter("serve_completed_total").value == len(LENS)
    for name in ("serve_steps_total", "sched_submitted_total",
                 "serve_decode_rounds_total"):
        assert name in registry, name
    snaps = [json.loads(ln) for ln in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(snaps) >= 2
    assert snaps[-1]["metrics"]["serve_completed_total"] == len(LENS)


@pytest.mark.parametrize("tree", [None, (2, 2)], ids=["chain", "tree"])
def test_temp0_engine_counters_match_reference(tiny_pair, tree):
    """The same weights and stream at temperature 0 through both engines
    with a registry and quality telemetry: tokens, the accepted-per-round
    histogram, the pooled attempted/accepted/drafted counts and the tenant
    pools equal; mean and per-depth TVD within 1e-5 (float32)."""
    jt, jtp, jd, jdp = tiny_pair["j"]
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = JEngine(target=jt, target_params=jtp, draft=jd, draft_params=jdp,
                   sd=jspec.SDConfig(gamma=2, temperature=0.0),
                   tree=None if tree is None else JTreeSpec(tree),
                   registry=jreg, quality=True, **ENGINE)
    teng = _port_engine(tiny_pair, tree, 0.0, registry=treg, quality=True)
    jres = jeng.serve(_requests(JRequest, tenants=True))
    tres = teng.serve(_requests(TRequest, tenants=True))
    for a, b in zip(tres, jres):
        assert np.array_equal(a.tokens, np.asarray(b.tokens)), a.request_id
    jh, th = (r.histogram("sd_accepted_per_round") for r in (jreg, treg))
    assert th.counts == jh.counts and th.sum == jh.sum
    for name in ("sd_tokens_total", "sd_blocks_total"):
        assert treg.counter(name).value == jreg.counter(name).value, name
    pools = [(teng.quality_stats, jeng.quality_stats)]
    pools += [(teng.tenant_quality[k], jeng.tenant_quality[k])
              for k in jeng.tenant_quality]
    assert set(teng.tenant_quality) == set(jeng.tenant_quality) == {"even", "odd"}
    pools += [(teng.stats[i].quality, jeng.stats[i].quality)
              for i in range(len(LENS))]
    for tq, jq in pools:
        assert tq.rounds == jq.rounds
        for name in ("attempted", "accepted", "drafted", "ent_bin_attempted",
                     "ent_bin_accepted"):
            assert np.array_equal(getattr(tq, name), getattr(jq, name)), name
        assert abs(tq.mean_tvd - jq.mean_tvd) < TOL
        np.testing.assert_allclose(tq.tvd_sum, jq.tvd_sum, atol=TOL * 100,
                                   rtol=0)   # sums over up to 100 positions
    assert teng.quality_stats.attempted.sum() > 0


def test_disabled_hooks_leave_the_engine_bare(tiny_pair):
    eng = _port_engine(tiny_pair, (2, 2), 0.7)
    eng.serve(_requests(TRequest))
    assert eng._tr is tobs.NULL_TRACER and eng.registry is None
    assert eng.recorder is None and eng.slo_tracker is None
    assert eng.quality_stats is None and "qual" not in eng._state
    assert eng.phases.steps == 0 and eng.phase_device_ms == {}
    assert all(s.quality is None for s in eng.stats.values())

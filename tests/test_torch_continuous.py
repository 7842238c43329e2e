"""The port's continuous-batching engine against the reference's
``ContinuousEngine`` at temperature 0, and the copied host modules
(scheduler, prefix cache, page allocator, traffic mixes) against theirs.

Engines run the reference test's tiny config (tests/test_continuous_serving
.py: d 64, 4 and 2 layers, V 64) in float32 with the same weights on both
sides, under staggered admission (2 slots, 4 requests of different
lengths, all arriving at t = 0 so that admission does not depend on the
wall clock): chain, tree, int8-KV and int8-weight configurations. Token
streams, telemetry counts and per-request tau must be equal; on the chat
mix with the prefix cache, so must the prefix-cache counters. The host
modules must give the same orders, tables and request streams for the same
inputs. Then the serving CLI with ``--continuous`` on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import speculative as jspec
from repro.models import Model as JModel
from repro.quant import calib as jcalib
from repro.serving import ContinuousEngine as JEngine
from repro.serving import PagedKVPool as JPool
from repro.serving import PrefixCache as JPrefix
from repro.serving import Scheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro.traffic import MIXES as JMIXES
from repro_torch.bridge import params_from_jax
from repro_torch.core import speculative as tspec
from repro_torch.launch import serve
from repro_torch.models.model import Model as TModel
from repro_torch.serving import ContinuousEngine as TEngine
from repro_torch.serving import PagedKVPool as TPool
from repro_torch.serving import PrefixCache as TPrefix
from repro_torch.serving import Request as TStaticRequest
from repro_torch.serving import Scheduler as TScheduler
from repro_torch.serving import ServeRequest as TRequest
from repro_torch.serving import ServingEngine as TStatic
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from repro_torch.traffic import MIXES as TMIXES
from torch_parity import one_torch_thread, port_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
            attn_chunk=16, remat=False, dtype="float32")
LENS, NEW = [6, 12, 8, 10], [8, 6, 10, 7]        # staggered: 4 requests, 2 slots
TEL = ("steps", "decode_rounds", "prefill_chunks", "admitted", "completed",
       "max_queue_depth")


@pytest.fixture(scope="module")
def tiny():
    """Reference and port (target, drafter) of the tiny config with the same
    float32 weights, unquantized ("fp") and int8-quantized ("int8", the
    reference's AWQ-calibrated ``quantize_params`` carried over)."""
    out = {}
    models = []
    for name, layers, seed in (("t", 4, 0), ("d", 2, 1)):
        jm = JModel(JConfig(name=name, arch_type="dense", num_layers=layers,
                            **BASE))
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        models.append((jm, jp, TModel(port_config(jm.cfg), device="cpu")))
    calib = np.random.default_rng(5).integers(0, 64, (4, 16)).astype(np.int32)
    for kind in ("fp", "int8"):
        sides = {"j": [], "t": []}
        for jm, jp, tm in models:
            if kind == "int8":
                jp = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int8"),
                                            calib_tokens=calib)
            sides["j"] += [jm, jp]
            sides["t"] += [tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                               tm.cfg, "cpu")]
        out[kind] = sides
    return out


def staggered(request_cls):
    rng = np.random.default_rng(2)
    return [request_cls(prompt=rng.integers(0, 64, L).astype(np.int32),
                        max_new_tokens=m, request_id=i)
            for i, (L, m) in enumerate(zip(LENS, NEW))]


def run_engines(sides, reqs_j, reqs_t, tree=None, gamma=2, **kw):
    """Serve the same requests through both engines; returns
    (reference engine, its results, port engine, its results), results
    sorted by request id."""
    jt, jtp, jd, jdp = sides["j"]
    tt, ttp, td, tdp = sides["t"]
    jeng = JEngine(target=jt, target_params=jtp, draft=jd, draft_params=jdp,
                   sd=jspec.SDConfig(gamma=gamma, temperature=0.0),
                   tree=None if tree is None else JTreeSpec(tree), **kw)
    teng = TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                   sd=tspec.SDConfig(gamma=gamma, temperature=0.0),
                   tree=None if tree is None else TTreeSpec(tree),
                   sanitize=True, **kw)
    out = []
    for eng, reqs in ((jeng, reqs_j), (teng, reqs_t)):
        for r in reqs:
            eng.submit(r)
        out += [eng, sorted(eng.run(), key=lambda r: r.request_id)]
    return out


def check_same(jeng, jres, teng, tres):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert np.array_equal(a.tokens, np.asarray(b.tokens)), a.request_id
        assert a.tau == b.tau, a.request_id
    for name in TEL:
        assert getattr(teng.telemetry, name) == getattr(jeng.telemetry, name), name
    assert list(teng.telemetry.active_rows) == list(jeng.telemetry.active_rows)
    assert list(teng.telemetry.free_pages) == list(jeng.telemetry.free_pages)


ENGINE_CASES = {   # name -> (weights, tree, int8 KV)
    "chain": ("fp", None, False),
    "tree": ("fp", (2, 2), False),
    "tree-int8kv": ("fp", (2, 2), True),
    "chain-int8w": ("int8", None, False),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_temp0_engine_tokens_match_reference(tiny, case):
    weights, tree, kv_quant = ENGINE_CASES[case]
    streamed = {}

    def on_token(rid, toks):
        streamed.setdefault(rid, []).extend(toks.tolist())

    reqs_t = staggered(TRequest)
    for r in reqs_t:
        r.on_token = on_token
    jeng, jres, teng, tres = run_engines(
        tiny[weights], staggered(JRequest), reqs_t, tree=tree, max_batch=2,
        max_seq_len=32, page_size=4, prefill_chunk=8, kv_quant=kv_quant)
    check_same(jeng, jres, teng, tres)
    assert teng.telemetry.max_queue_depth >= 1      # someone had to wait
    for r in tres:                                  # streamed == returned
        assert streamed[r.request_id] == r.tokens.tolist()
        assert len(r.tokens) == NEW[r.request_id]
    if not kv_quant:
        # greedy exactness: the static chain engine's tokens (dense caches)
        tt, ttp, td, tdp = tiny[weights]["t"]
        static = TStatic(target=tt, target_params=ttp, draft=td,
                         draft_params=tdp,
                         sd=tspec.SDConfig(gamma=2, temperature=0.0))
        for a in sorted(static.serve(staggered(TStaticRequest)),
                        key=lambda r: r.request_id):
            assert np.array_equal(a.tokens, tres[a.request_id].tokens)


def _cow_requests(request_cls):
    """Two identical page-aligned prompts: the second hits both pages, its
    hit is clamped to prompt_len - 1, and its re-prefill of the last prompt
    token lands in the last shared page (copy on write)."""
    prompt = np.random.default_rng(6).integers(0, 64, 16).astype(np.int32)
    return [request_cls(prompt=prompt.copy(), max_new_tokens=6, request_id=i)
            for i in range(2)]


PREFIX_CASES = {   # name -> (requests, engine sizes)
    "chat": (lambda cls: [cls(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                              request_id=r.request_id)
                          for r in TMIXES["chat"].build(6, 0.0, 64, seed=0)],
             dict(max_batch=2, max_seq_len=80, page_size=16, prefill_chunk=32)),
    "cow": (_cow_requests,
            dict(max_batch=1, max_seq_len=32, page_size=8, prefill_chunk=8)),
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_cache_matches_reference(tiny, case):
    make, sizes = PREFIX_CASES[case]
    jeng, jres, teng, tres = run_engines(tiny["fp"], make(JRequest),
                                         make(TRequest), gamma=3,
                                         prefix_cache=True, **sizes)
    check_same(jeng, jres, teng, tres)
    for name in ("lookups", "hits", "hit_tokens", "prompt_tokens",
                 "pages_inserted", "evictions", "cow_copies"):
        assert getattr(teng.prefix.tel, name) == getattr(jeng.prefix.tel, name), name
    assert teng.prefix.tel.hits > 0
    if case == "cow":
        assert teng.prefix.tel.cow_copies == 1
    # prefix cache off: the same tokens, bit for bit
    tt, ttp, td, tdp = tiny["fp"]["t"]
    off = TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                  sd=tspec.SDConfig(gamma=3, temperature=0.0), **sizes)
    for a, b in zip(off.serve(make(TRequest)), tres):
        assert np.array_equal(a.tokens, b.tokens)


def test_tree_prefix_cache_on_equals_off(tiny):
    tt, ttp, td, tdp = tiny["fp"]["t"]
    make, sizes = PREFIX_CASES["chat"]
    out = []
    for prefix in (False, True):
        eng = TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                      sd=tspec.SDConfig(temperature=0.0), tree=TTreeSpec((2, 2)),
                      prefix_cache=prefix, sanitize=True, **sizes)
        out.append(eng.serve(make(TRequest)))
    assert eng.prefix.tel.hits > 0
    for a, b in zip(*out):
        assert np.array_equal(a.tokens, b.tokens)


def test_engine_refuses_recurrent_models_and_oversized_requests(tiny):
    tt, ttp, td, tdp = tiny["fp"]["t"]
    hybrid = TModel(tt.cfg.replace(layer_pattern=("mamba", "attn")), "cpu")
    with pytest.raises(ValueError, match="recurrent"):
        TEngine(target=hybrid, target_params=None, draft=td, draft_params=tdp)
    with pytest.raises(ValueError, match="speculative-only"):
        TEngine(target=tt, target_params=ttp)
    eng = TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                  max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(TRequest(prompt=np.zeros(10, np.int32), max_new_tokens=10))
    tight = TEngine(target=tt, target_params=ttp, draft=td, draft_params=tdp,
                    max_seq_len=64, num_pages=4, page_size=8)
    with pytest.raises(ValueError, match="KV pages"):
        tight.submit(TRequest(prompt=np.zeros(20, np.int32), max_new_tokens=20))


# ------------------------------------------------------------ host modules

def _scheduler_trace(sched_cls, request_cls, policy, aging):
    """Pop order of a random submit/pop trace with capacity refusals."""
    rng = np.random.default_rng(11)
    sched = sched_cls(policy, aging_s=aging)
    order, rid = [], 0
    for step in range(60):
        for _ in range(int(rng.integers(0, 3))):
            sched.submit(request_cls(prompt=np.zeros(4, np.int32),
                                     request_id=rid,
                                     priority=int(rng.integers(0, 4)),
                                     arrival_time_s=float(rng.uniform(0, 6))))
            rid += 1
        now = step * 0.1
        cap = rng.random() < 0.6
        got = sched.pop_admissible(now, lambda r: cap)
        order.append((None if got is None else got.request_id,
                      sched.ready_depth(now), len(sched)))
    return order


def _pool_trace(pool_cls):
    """Tables, refcounts and returns of a random alloc/free/fork/release/
    cow/compact trace."""
    rng = np.random.default_rng(12)
    pool = pool_cls(num_pages=24, page_size=4, max_pages_per_seq=6)
    out, held = [], []
    for _ in range(200):
        op = int(rng.integers(0, 6))
        slots = sorted(pool._owned)
        try:
            if op == 0:
                slot = int(rng.integers(0, 5))
                shared = (pool._owned[slots[0]][:int(rng.integers(0, 2))]
                          if slots and slot not in pool._owned else [])
                out.append(("alloc", pool.alloc(slot, int(rng.integers(1, 24)),
                                                shared=shared)))
            elif op == 1 and slots:
                out.append(("free", pool.free_slot(slots[0])))
            elif op == 2 and slots:
                pages = pool._owned[slots[-1]][:2]
                pool.fork(pages)
                held.append(pages)
                out.append(("fork", pages))
            elif op == 3 and held:
                out.append(("release", pool.release(held.pop(0))))
            elif op == 4 and slots:
                out.append(("cow", pool.cow_page(slots[-1], 0)))
            elif op == 5:
                perm = pool.compact()
                out.append(("compact", None if perm is None else perm.tolist()))
                held = []                      # renumbered: drop old ids
        except (MemoryError, ValueError) as e:
            out.append(("error", type(e).__name__))
        out.append(("state", pool.num_free, sorted(pool._ref.items()),
                    [pool.table_row(s).tolist() for s in range(5)]))
    return out


def _prefix_trace(pool_cls, prefix_cls):
    """Matches, inserts and LRU evictions of the radix cache over a pool."""
    rng = np.random.default_rng(13)
    pool = pool_cls(num_pages=64, page_size=4, max_pages_per_seq=8)
    cache = prefix_cls(pool, 4)
    stems = [rng.integers(0, 5, 12) for _ in range(3)]
    out = []
    for i in range(40):
        toks = np.concatenate([stems[i % 3], rng.integers(0, 5, 8)])[
            :int(rng.integers(4, 20))]
        hit, pages = cache.match(toks)
        slot = i % 6
        if slot in pool._owned:
            out.append(("free", pool.free_slot(slot)))
        if pool.can_alloc_shared(len(toks), len(pages)):
            pool.alloc(slot, len(toks), shared=pages)
            cache.insert(toks, pool._owned[slot])
        if rng.random() < 0.3:
            out.append(("evict", cache.evict_lru_leaf(protect=pages[:1])))
        out.append((hit, pages, cache.num_nodes,
                    sorted(map(tuple, cache.cached_prefixes()))))
    t = cache.tel
    out.append((t.pages_inserted, t.evictions))
    return out


HOST_CASES = {
    "scheduler-fcfs": lambda J: _scheduler_trace(
        JScheduler if J else TScheduler, JRequest if J else TRequest, "fcfs", None),
    "scheduler-priority-aging": lambda J: _scheduler_trace(
        JScheduler if J else TScheduler, JRequest if J else TRequest,
        "priority", 0.5),
    "kv-pool": lambda J: _pool_trace(JPool if J else TPool),
    "prefix-cache": lambda J: _prefix_trace(JPool if J else TPool,
                                            JPrefix if J else TPrefix),
    "traffic": lambda J: [
        [(r.prompt.tolist(), r.max_new_tokens, r.request_id, r.priority,
          r.arrival_time_s, r.tenant)
         for r in (JMIXES if J else TMIXES)[mix].build(12, 5.0, 512, seed=3)]
        for mix in sorted(JMIXES)],
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_copied_host_modules_match_reference(case):
    assert HOST_CASES[case](False) == HOST_CASES[case](True)


# ------------------------------------------------------------ the CLI

CLI = ["--arch", "llama2-7b-chat", "--reduced", "--continuous", "--tree",
       "--prefix-cache", "--traffic-mix", "chat", "--requests", "6"]


def test_serve_cli_continuous_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "continuous: 6 requests" in proc.stdout
    assert "prefix cache: hit_rate=" in proc.stdout


def test_serve_cli_continuous_quantized_in_process(capsys):
    serve.main(["--arch", "llama2-7b-chat", "--reduced", "--continuous",
                "--quant-weights", "int8", "--quant-target", "--quant-kv",
                "--requests", "3", "--prompt-len", "8", "--max-new", "6",
                "--arrival-rate", "50", "--mixed-lens", "--calib-seqs", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests, 18 tokens" in out
    assert "kv=int8" in out


def test_serve_cli_continuous_needs_a_card_or_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(CLI)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama2-7b-chat", "--prefix-cache"])   # no --continuous


@pytest.mark.parametrize("flag", ["--trace-out", "--metrics-out",
                                  "--time-phases", "--quality-telemetry",
                                  "--flight-record", "--draft-head"])
def test_serve_cli_rejects_unported_flags(flag):
    """The reference CLI's observability and draft-head flags wait for later
    slices: argparse refuses them rather than ignoring them."""
    with pytest.raises(SystemExit):
        serve.main([*CLI, "--device", "cpu", flag, "x"])

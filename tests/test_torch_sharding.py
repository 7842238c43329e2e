"""The port's sharded step (``sharding.context``, ``launch.collectives``,
the sharded trace of ``launch.dryrun``, the optimized profile's
constraints) against the reference, on the CPU.

A fake process group of 16 ranks is installed for this module and torn
down after it; its (4, 4) mesh over (data, model) carries DTensors of fake
tensors, so nothing is allocated. ``maybe_constraint`` is the identity
without a mesh and on a plain tensor, and gives the spec's placements on a
DTensor; the recorder's bytes equal hand-computed result bytes for an
all-gather, an all-reduce and a reduce-scatter, in their functional and
eager forms; ``_opt_seq_shard`` and ``_maybe_seq_shard_ffn`` request the
reference's specs (its functions run with a sizes-only mesh and their
constraints recorded) for a head count the model axis does not divide,
and the sharded trace attends per key shard where they split K/V (the
reduced configs' sharded traces at the four shapes share their inputs
with ``test_torch_dryrun.py``'s); and a mesh of one over gloo (in a
subprocess: one default group a process) leaves the served tokens and
logits of the port unchanged.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.configs as jcfgs
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.sharding import context as jctx
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.collectives import StepRecorder
from repro_torch.launch.specs import input_specs
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import context, rules
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"data": 4, "model": 4}


class SizesMesh:
    """The reference's mesh as its constraint helpers read it: sizes."""
    shape = dict(SIZES)


@pytest.fixture(scope="module")
def mesh():
    """A (data 4, model 4) DeviceMesh over the fake backend, this module's
    only process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    yield make_mesh((4, 4), ("data", "model"))
    context.set_mesh(None)
    context.set_profile("baseline")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mode():
    return FakeTensorMode()


def dtensor(mode, mesh, shape, placements=None):
    local = mode.from_tensor(torch.empty(shape, device="meta"))
    placements = placements or [Replicate(), Replicate()]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def test_maybe_constraint(mesh, mode):
    """The identity with no mesh (plain tensor or DTensor) and on a plain
    tensor with a mesh; on a DTensor the spec's placements, the shape
    kept, also where it already has them."""
    x = torch.zeros(8, 4)
    d = dtensor(mode, mesh, (8, 16, 4))
    assert context.get_mesh() is None
    assert context.maybe_constraint(x, "data") is x
    assert context.maybe_constraint(d, "data") is d
    with context.use_mesh(mesh, ("data",), "model"):
        assert context.maybe_constraint(x, "data", "model") is x
        with mode:
            y = context.maybe_constraint(d, "data", "model")
            assert y.placements == (Shard(0), Shard(1))
            assert tuple(y.shape) == (8, 16, 4)
            assert context.maybe_constraint(y, "data", "model").placements \
                == y.placements
            z = context.maybe_constraint(y, None, ("data", "model"))
            assert z.placements == (Shard(1), Shard(1))
            assert context.maybe_constraint(z).placements == \
                (Replicate(), Replicate())
    assert context.get_mesh() is None


def test_recorder_counts_result_bytes(mesh, mode):
    """Result bytes by kind: a (4, 8) float32 shard all-gathered over
    model (4 ranks) is 512 B, a (4, 8) float32 all-reduce 128 B, a (16, 8)
    bfloat16 reduce-scatter over data 64 B; the eager c10d forms count
    their first argument. A DTensor redistribute counts what it runs: a
    (16, 8) float32 shard of data gathered whole, 2,048 B."""
    from torch.distributed import _functional_collectives as funcol
    model, data = mesh["model"], mesh["data"]
    with mode:
        a = torch.empty(4, 8)
        b = torch.empty(16, 8, dtype=torch.bfloat16)
        with StepRecorder() as rec:
            funcol.wait_tensor(funcol.all_gather_tensor(a, 0, model))
            funcol.wait_tensor(funcol.all_reduce(a, "sum", model))
            funcol.wait_tensor(funcol.reduce_scatter_tensor(b, "sum", 0, data))
        assert rec.collectives() == {"all-reduce": 128, "all-gather": 512,
                                     "reduce-scatter": 64}
        with StepRecorder() as rec:
            dist.all_reduce(a, group=model.get_group())
            out = torch.empty(16, 8)
            dist.all_gather_into_tensor(out, a, group=model.get_group())
        assert rec.collectives() == {"all-reduce": 128, "all-gather": 512}
    d = dtensor(mode, mesh, (16, 8), [Shard(0), Replicate()])   # (64, 8)
    with mode, StepRecorder() as rec:
        d.redistribute(mesh, [Replicate(), Replicate()])
    assert rec.collectives() == {"all-gather": 64 * 8 * 4}


def _reference_specs(fn, *args):
    """The specs the reference's constraint helper requests from ``fn``
    with a sizes-only mesh in the optimized profile."""
    asked = []
    keep = jctx.maybe_constraint
    jctx.maybe_constraint = lambda x, *spec: asked.append(spec) or x
    old = (jctx.get_mesh(), jctx.data_axes(), jctx.model_axis(), jctx.profile())
    jctx.set_mesh(SizesMesh(), ("data",), "model", profile="optimized")
    try:
        fn(*args)
    finally:
        jctx.maybe_constraint = keep
        jctx.set_mesh(*old[:3], profile=old[3])
    return asked


@pytest.mark.parametrize("batch", (4, 2))
def test_optimized_constraints_place_as_the_reference(mesh, mode, batch):
    """6 heads on a model axis of 4: ``_opt_seq_shard`` sequence-shards K
    and V and ``_maybe_seq_shard_ffn`` the FFN input, batch over data
    where it divides; the port's DTensors end with the placements of the
    reference's requested specs. The baseline profile leaves them."""
    jcfg = jcfgs.reduced(jcfgs.get_config("phi4-mini-3.8b")).replace(
        num_heads=6, num_kv_heads=2)
    qkv = [np.zeros((batch, 8, h, 16)) for h in (6, 2, 2)]
    want = _reference_specs(jattn._opt_seq_shard, *qkv, jcfg)
    want += _reference_specs(jtfm._maybe_seq_shard_ffn,
                             np.zeros((batch, 4096, 32)))
    assert len(want) == 4
    tcfg = tcfgs.reduced(tcfgs.get_config("phi4-mini-3.8b")).replace(
        num_heads=6, num_kv_heads=2)
    q, k, v = (dtensor(mode, mesh, a.shape) for a in qkv)
    h = dtensor(mode, mesh, (batch, 4096, 32))
    with context.use_mesh(mesh, ("data",), "model"), mode:
        context.set_profile("optimized")
        try:
            got = list(tattn._opt_seq_shard(q, k, v, tcfg))
            got.append(ttfm._maybe_seq_shard_ffn(h))
        finally:
            context.set_profile("baseline")
        assert [t.placements for t in got] == [
            rules.placements(tuple(rules.norm_axis(a) for a in s), mesh)
            for s in want]
        assert tattn._opt_seq_shard(q, k, v, tcfg) == (q, k, v)
        assert ttfm._maybe_seq_shard_ffn(h) is h


def test_optimized_profile_attends_per_key_shard(mesh, mode, monkeypatch):
    """6 heads on a model axis of 4 in the optimized profile: prefill and a
    train step (its backward through the softmax's reductions) attend
    with K/V split on the sequence by ``_opt_seq_shard``, and a decode
    step against its sequence-sharded cache, all in the per-key-shard
    region (``_sdpa_seq_sharded``), whose statistics and outputs are the
    all-reduces it adds; the baseline profile's prefill does not."""
    cfg = tcfgs.reduced(tcfgs.get_config("phi4-mini-3.8b")).replace(
        num_heads=6, num_kv_heads=2, head_dim=32)
    calls = []
    region = tattn._sdpa_seq_sharded
    monkeypatch.setattr(tattn, "_sdpa_seq_sharded",
                        lambda *a: calls.append(1) or region(*a))
    for kind, seq, profile in (("prefill", 128, "optimized"),
                               ("train", 64, "optimized"),
                               ("decode", 256, "optimized"),
                               ("prefill", 128, "baseline")):
        shape = ShapeConfig("x", seq, 8, kind)
        specs = input_specs(cfg, shape, mesh, mode, profile=profile)
        calls.clear()
        context.set_profile(profile)
        try:
            with context.use_mesh(mesh, ("data",), "model"):
                r = dryrun.trace_sharded(cfg, shape, specs, mesh, mode)
        finally:
            context.set_profile("baseline")
        if profile == "baseline":
            assert not calls, kind
        else:
            assert len(calls) >= cfg.num_layers, (kind, len(calls))
            assert r["collectives"]["all-reduce"] > 0, (kind, r)


SERVE_ONE = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    import repro_torch.configs as tcfgs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding import context
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1),
                            rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch in ("granite-moe-3b-a800m", "yi-9b"):
        cfg = tcfgs.reduced(tcfgs.get_config(arch))
        if cfg.is_moe:   # nothing drops: the mesh's per-shard capacity is moot
            cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                              / cfg.num_experts_per_tok)
        model = Model(cfg, device="cpu")
        params = model.init(0, dtype=torch.float32)
        prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                               generator=torch.Generator().manual_seed(0))
        runs = {}
        for label, profile in (("none", None), ("baseline", "baseline"),
                               ("optimized", "optimized")):
            ctx = context.use_mesh(mesh if profile else None, ("data",),
                                   "model")
            context.set_profile(profile or "baseline")
            with ctx:
                logits, cache = model.prefill(params, prompt, 20)
                toks, steps = [logits[:, -1].argmax(-1)], [logits]
                for t in range(6):
                    pos = torch.full((2, 1), 12 + t, dtype=torch.int32)
                    logits, cache = model.decode_step(
                        params, toks[-1][:, None], pos, cache)
                    steps.append(logits)
                    toks.append(logits[:, -1].argmax(-1))
            runs[label] = (torch.stack(toks, 1), steps)
        ref_t, ref_s = runs["none"]
        out[arch] = {label: [torch.equal(t, ref_t),
                             all(torch.equal(a, b) for a, b in zip(s, ref_s))]
                     for label, (t, s) in runs.items()}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def serve_one(tmp_path_factory):
    """The mesh-of-one serving run, started first so that it runs beside
    this module's traces."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    store = tmp_path_factory.mktemp("serve_one") / "store"
    proc = subprocess.Popen([sys.executable, "-c", SERVE_ONE, str(store)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_serving_with_a_mesh_of_one_is_unchanged(serve_one):
    """Greedy prefill and decode of reduced granite (MoE layers through
    their mesh path at cf E/k) and Yi, float32, with a (1, 1) mesh over
    gloo installed, in both profiles: tokens and logits equal to those
    without a mesh, bit for bit."""
    stdout, stderr = serve_one.communicate(timeout=300)
    assert serve_one.returncode == 0, stderr[-3000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    for arch, runs in out.items():
        assert all(all(v) for v in runs.values()), (arch, runs)

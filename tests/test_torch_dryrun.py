"""The dry run of the port (``launch.{roofline,specs,dryrun}``,
``sharding/``) against ``repro``, on the CPU with no allocation.

The roofline models are the reference's formulas, so every function must
return the reference's number exactly for every arch and assigned shape;
``roofline_terms`` differs only by the H100's constants. The sharding rules
must give the reference's mesh axes for every leaf of every arch's
parameters, on the reference test's ``FakeMesh`` sizes and on the
production meshes' (the reference's stacked spec tree taken apart in the
bridge's layer order). The shape-only init must build the seeded init's
shapes and dtypes. The FLOPs the dry run counts on fake tensors must equal
``FlopCounterMode`` on real CPU tensors, and fall within 0.5-2x of the
analytic model (the reference's ``test_flops_model_vs_cost_analysis_
unrolled``). The CLI runs every assigned arch at ``decode_32k`` at full
width in subprocesses on the production mesh without reading a card or
growing past a few hundred MB of host memory, whatever its arguments
weigh; the reduced configs run at the four shape kinds in-process.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jcfgs
from repro.configs.base import ModelConfig as JConfig
from repro.launch import roofline as jroof
from repro.models import Model as JModel
from repro.sharding import rules as jrules
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.specs import argument_bytes, input_specs
from repro_torch.models.model import Model
from repro_torch.optim import tree_leaves
from repro_torch.sharding import rules
from repro_torch.training import make_train_state, make_train_step
from torch_parity import one_torch_thread, port_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(jcfgs.ARCHS)
SHAPES = list(jcfgs.INPUT_SHAPES)
# the reference test's FakeMesh sizes, and the production meshes'
MESHES = {"fake": {"data": 4, "model": 2},
          "pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


class Mesh:
    """A mesh stand-in: only its axis sizes are read."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def shape_pair(name):
    s = jcfgs.INPUT_SHAPES[name]
    return s, tcfgs.INPUT_SHAPES[name]


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_functions_equal_the_references(arch):
    """Every analytic model at every assigned shape, meshes of 256 and 512
    chips, both profiles, with and without long context: the same
    numbers."""
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert roofline.active_params(t) == jroof.active_params(j)
    for name in SHAPES:
        js, ts = shape_pair(name)
        assert ts == ShapeConfig(js.name, js.seq_len, js.global_batch, js.kind)
        for long_ctx in (False, True):
            assert roofline.flops_model(t, ts, long_ctx) == \
                jroof.flops_model(j, js, long_ctx)
            assert roofline._cache_bytes(t, ts, long_ctx) == \
                jroof._cache_bytes(j, js, long_ctx)
            for chips in (256, 512):
                for profile in ("baseline", "optimized"):
                    assert roofline.bytes_model(t, ts, chips, long_ctx, profile) == \
                        jroof.bytes_model(j, js, chips, long_ctx, profile)
        assert roofline.model_flops(t, ts) == jroof.model_flops(j, js)
        for kind in set(t.layer_pattern):
            for ctx, dec in ((ts.seq_len, True), (ts.seq_len / 2.0, False)):
                assert roofline._layer_flops_per_token(t, kind, ctx, dec) == \
                    jroof._layer_flops_per_token(j, kind, ctx, dec)


def test_roofline_terms_differ_only_by_the_constants():
    """The port's terms are the reference's scaled by the ratio of the
    TPU's rates to the H100's data-sheet rates; the bottleneck follows."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    for fl, by, co in ((1e12, 1e9, 1e8), (1e9, 1e12, 1e8), (1e9, 1e6, 1e12)):
        t, j = roofline.roofline_terms(fl, by, co), jroof.roofline_terms(fl, by, co)
        for key, const, jconst in (("t_compute_s", roofline.PEAK_FLOPS, jroof.PEAK_FLOPS),
                                   ("t_memory_s", roofline.HBM_BW, jroof.HBM_BW),
                                   ("t_collective_s", roofline.LINK_BW, jroof.LINK_BW)):
            assert t[key] == pytest.approx(j[key] * jconst / const, rel=1e-12)
        assert t["t_bound_s"] == max(t["t_compute_s"], t["t_memory_s"],
                                     t["t_collective_s"])
    a = roofline.analyze(tcfgs.get_config("yi-9b"), tcfgs.INPUT_SHAPES["decode_32k"],
                         256)
    assert a["t_collective_s"] is None and a["collectives"] is None
    assert a["collective_bytes_per_chip"] is None
    assert a["bottleneck"] == "memory"
    # counted collectives: their sum is the bytes per chip, over NVLink's
    # rate the term, and the largest term the bottleneck
    coll = {"all-gather": 3e9, "all-reduce": 1e9}
    a = roofline.analyze(tcfgs.get_config("yi-9b"), tcfgs.INPUT_SHAPES["decode_32k"],
                         256, collectives=coll)
    assert a["collectives"] == coll and a["collective_bytes_per_chip"] == 4e9
    assert a["t_collective_s"] == pytest.approx(4e9 / 450e9, rel=1e-12)
    assert a["bottleneck"] == "collective" and a["t_bound_s"] == a["t_collective_s"]


def test_logical_to_pspec_equals_the_references():
    """The reference's basic and divisibility-fallback cases, and every
    rule table on each mesh's sizes (an axis absent from the mesh, a
    tuple of axes, non-divisible dims); the DTensor placements each
    implies."""
    fake = Mesh(MESHES["fake"])
    assert rules.logical_to_pspec(("fsdp", "tp"), fake, (8, 8)) == ("data", "model")
    assert rules.logical_to_pspec((None, "tp"), fake, (8, 8)) == (None, "model")
    assert rules.logical_to_pspec(("fsdp", "tp"), fake, (6, 8)) == (None, "model")
    assert rules.logical_to_pspec(("fsdp", "tp"), fake, (6, 7)) == ()
    specs = [("fsdp", "tp"), ("tp", "fsdp"), (None, "expert_fsdp", "tp"),
             ("batch", None), ("batch", "cache_seq"), (None,), ("tp",), ()]
    for sizes in MESHES.values():
        mesh = Mesh(sizes)
        for spec in specs:
            for shape in ((32, 64, 96)[:len(spec)], (6, 24, 7)[:len(spec)],
                          (512, 2048, 16)[:len(spec)], None):
                for which in (None, "inference"):
                    r = rules.INFERENCE_RULES if which else None
                    jr = jrules.INFERENCE_RULES if which else None
                    assert rules.logical_to_pspec(spec, mesh, shape, r) == \
                        tuple(jrules.logical_to_pspec(spec, mesh, shape, jr))
    prod = Mesh(MESHES["multipod"])
    ps = rules.logical_to_pspec(("batch", "tp"), prod, (64, 32))
    assert ps == (("pod", "data"), "model")
    assert rules.placements(ps, prod) == (Shard(0), Shard(0), Shard(1))
    assert rules.placements((None, "model"), Mesh(MESHES["pod"])) == \
        (Replicate(), Shard(1))
    assert rules.local_shape((64, 32), ps, prod) == (2, 2)


def _reference_specs(jcfg):
    """(spec tree, shape tree) of the reference's init, not run."""
    box = {}
    jm = JModel(jcfg)

    def init():
        p, s = jm.init(jax.random.PRNGKey(0))
        box["specs"] = s
        return p

    shapes = jax.eval_shape(init)
    return box["specs"], jax.tree.map(lambda s: tuple(s.shape), shapes)


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _in_port_order(tree, cfg):
    """The reference's tree (specs or shapes, one stacked axis on groups and
    shared sets) in the port's layout, as ``bridge.params_from_jax`` lays
    out parameters: layer r * len(g) + k is ``groups[k]`` at repetition r,
    then the remainder; a shared_attn layer's own dict is empty; shared
    sets apart. Stacked leaves lose their leading entry; the pair tree is
    (spec, shape)."""
    g, n, rem = cfg.pattern_blocks()

    def unstack(sub):
        return jax.tree.map(lambda leaf: (leaf[0][1:], leaf[1][1:]), sub,
                            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                            and _is_spec(x[0]))

    layers = [{} if g[k] == "shared_attn" else unstack(tree["groups"][k])
              for _ in range(n) for k in range(len(g))]
    layers += [{} if kind == "shared_attn" else tree["rem"][j]
               for j, kind in enumerate(rem)]
    out = {k: v for k, v in tree.items() if k not in ("groups", "rem",
                                                     "shared_attn")}
    out["layers"] = layers
    if "shared_attn" in tree:
        set0 = unstack(tree["shared_attn"])
        out["shared_attn"] = [set0] * cfg.num_shared_attn_sets
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch):
    """``param_specs`` at full width against the reference's spec tree
    leaf by leaf, and each leaf's mesh axes (``make_param_shardings`` over
    the shape-only init) against the reference's ``logical_to_pspec`` of
    its stacked leaf on every mesh, with both rule tables."""
    jcfg, cfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jspecs, jshapes = _reference_specs(jcfg)
    pairs = jax.tree.map(lambda s, sh: (tuple(s), sh), jspecs, jshapes,
                         is_leaf=_is_spec)
    want = _in_port_order(pairs, cfg)
    got = rules.param_specs(cfg)
    params = Model(cfg, device="meta").init(0)
    flat_want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)
                                and len(x) == 2 and _is_spec(x[0]))
    assert [s for s, _ in flat_want] == jax.tree.leaves(got, is_leaf=_is_spec)
    shapes = [tuple(p.shape) for p in jax.tree.leaves(params)]
    assert shapes == [sh for _, sh in flat_want]
    for sizes in MESHES.values():
        mesh = Mesh(sizes)
        for r, jr in ((None, None), (rules.INFERENCE_RULES, jrules.INFERENCE_RULES)):
            sh = rules.make_param_shardings(got, params, mesh, r)
            leaves = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
                x, rules.ParamSharding))
            assert len(leaves) == len(flat_want)
            for leaf, (spec, shape) in zip(leaves, flat_want):
                assert leaf.pspec == tuple(jrules.logical_to_pspec(
                    spec, mesh, shape, jr))
                assert leaf.placements == rules.placements(leaf.pspec, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_only_init_matches_the_seeded_init(arch):
    """``Model.init`` on the meta device builds every leaf of the seeded
    CPU init with its shape and dtype, in every dtype the port builds, and
    draws nothing; seeded inits stay seeded."""
    cfg = tcfgs.reduced(tcfgs.get_config(arch))
    for dtype in (None, torch.float32):
        meta = tree_leaves(Model(cfg, device="meta").init(0, dtype=dtype))
        real = tree_leaves(Model(cfg, device="cpu").init(0, dtype=dtype))
        assert [(tuple(x.shape), x.dtype) for x in meta] == \
            [(tuple(x.shape), x.dtype) for x in real]
        assert all(x.device.type == "meta" for x in meta)
    again = tree_leaves(Model(cfg, device="cpu").init(0, dtype=torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(real, again))


# a tiny unrolled dense model (the reference test's "v" config)
TINY = JConfig(name="v", arch_type="dense", num_layers=1, d_model=128,
               num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
               vocab_size=256, attn_chunk=64, remat=False, dtype="float32")


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_counted_flops_equal_the_flop_counter_on_real_tensors(kind):
    """The dry run's count on fake tensors equals ``FlopCounterMode`` over
    the same step on real CPU tensors (a reduced Yi and the tiny model),
    and a forward's count falls within 0.5-2x of the analytic model."""
    for cfg in (port_config(TINY), tcfgs.reduced(tcfgs.get_config("yi-9b"))):
        shape = ShapeConfig("x", 64, 4, kind)
        mesh = Mesh(MESHES["fake"])
        mode = FakeTensorMode()
        inputs = input_specs(cfg, shape, mesh, mode)
        counted = dryrun.trace_step(cfg, shape, inputs, mode)
        model = Model(cfg, device="cpu")
        rng = np.random.default_rng(0)

        def ids(*s):
            return torch.from_numpy(rng.integers(0, cfg.vocab_size, s)).int()

        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                state = make_train_state(model, 0, TrainConfig())
                toks = ids(4, 64)
                make_train_step(model, TrainConfig())(state, toks, toks)
            elif kind == "prefill":
                model.prefill(model.init(0, torch.float32), ids(4, 64), 64)
            else:
                model.decode_step(model.init(0, torch.float32), ids(4, 1),
                                  torch.zeros((4, 1), dtype=torch.int32),
                                  model.init_cache(4, 64))
        assert counted == fc.get_total_flops() > 0
    # the reference's unrolled check: a forward with logits at every
    # position against flops_model plus the head at the other positions
    cfg, B, S = port_config(TINY), 4, 64
    shape = ShapeConfig("x", S, B, "prefill")
    mode = FakeTensorMode()
    inputs = input_specs(cfg, shape, Mesh(MESHES["fake"]), mode)
    with mode, FlopCounterMode(display=False) as fc:
        Model(cfg, device="meta").logits(inputs["params"][0],
                                         inputs["tokens"][0])
    ours = roofline.flops_model(cfg, shape) \
        + 2 * cfg.d_model * cfg.vocab_size * B * (S - 1)
    assert 0.5 < ours / fc.get_total_flops() < 2.0


@pytest.fixture(scope="module")
def fake_mesh():
    """A DeviceMesh of the reference test's FakeMesh sizes (data 4, model
    2) over the fake backend: this module's only process group, torn down
    after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    yield make_mesh((4, 2), ("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(jcfgs.ASSIGNED))
def test_reduced_configs_run_at_the_four_shapes(arch, fake_mesh):
    """Each reduced config through ``dryrun.run_cfg`` on the reference
    test's FakeMesh sizes at the four assigned shapes' kinds and batches:
    decode_32k and long_500k at their own lengths; train_4k and
    prefill_32k at 1/64 of theirs (the trace's op count grows with the
    length: 20-130 s a combination at full length on this CPU). Counted
    FLOPs above half the analytic model and, for a dense config, below
    2.5x; the analytic numbers the roofline's; the arguments small. The
    mesh is a DeviceMesh, so the same inputs are traced sharded too: a
    collective term (bytes by kind, over NVLink's rate) and one rank's
    memory, whose arguments are the argument bytes (labels alias tokens
    in a train step, so counted once there) and whose peak holds them and
    the outputs."""
    cfg = tcfgs.reduced(tcfgs.get_config(arch))
    mesh = fake_mesh
    for name, s in tcfgs.INPUT_SHAPES.items():
        seq = s.seq_len if s.kind == "decode" else s.seq_len // 64
        shape = ShapeConfig(name, seq, s.global_batch, s.kind)
        r = dryrun.run_cfg(cfg, shape, mesh)
        assert r["ok"] and r["chips"] == 8 and r["mesh"] == MESHES["fake"]
        # an MoE layer runs at least 8 slots an expert whatever the tokens
        # (``_moe_local``'s capacity floor), which the analytic model's k x
        # cf a token leaves out: at one token a row it counts above 2.5x
        hi = math.inf if cfg.is_moe else 2.5
        assert 0.5 < r["counted_over_analytic"] < hi, (name, r)
        assert r["flops_per_chip"] == pytest.approx(
            roofline.flops_model(cfg, shape, name == "long_500k") / 8)
        assert 0 < r["argument_bytes_per_rank"] < 2e9
        assert r["fits_one_card"]
        coll = r["collectives"]
        assert coll and set(coll) <= {"all-reduce", "all-gather",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute"}, (name, r)
        assert r["collective_bytes_per_chip"] == sum(coll.values()) > 0
        assert r["t_collective_s"] == pytest.approx(
            r["collective_bytes_per_chip"] / roofline.LINK_BW)
        labels = s.global_batch * cfg.num_codebooks * seq * 4 // 4 \
            if s.kind == "train" else 0
        m = r["memory"]
        assert m["argument_bytes"] == r["argument_bytes_per_rank"] - labels
        assert m["peak_bytes"] >= m["argument_bytes"] + m["output_bytes"]
        assert m["output_bytes"] > 0


def test_argument_bytes_are_the_local_shards():
    """One rank's argument bytes: every leaf's local shard (a divisible dim
    split over its axes) at its dtype's size."""
    cfg = tcfgs.reduced(tcfgs.get_config("musicgen-large"))
    shape = ShapeConfig("d", 64, 8, "decode")
    mesh = Mesh(MESHES["fake"])
    mode = FakeTensorMode()
    specs = input_specs(cfg, shape, mesh, mode)
    total = 0
    for tree, shard in specs.values():
        leaves = jax.tree.leaves(tree)
        shards = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(
            x, rules.ParamSharding))
        for leaf, sh in zip(leaves, shards):
            n = leaf.numel()
            for axis in sh.pspec:
                for a in (axis if isinstance(axis, tuple) else (axis,)):
                    n //= MESHES["fake"].get(a, 1)
            total += n * leaf.element_size()
    assert argument_bytes(specs, mesh) == total
    # decode inputs: params, a cache of 64 slots, one (B, K, 1) id a row
    assert tuple(specs["tokens"][0].shape) == (8, 4, 1)
    assert specs["tokens"][1].pspec == ("data",)
    assert tuple(specs["cache"][0][0]["k"].shape) == (8, 64, cfg.num_kv_heads,
                                                      cfg.head_dim_)
    one = argument_bytes(input_specs(cfg, shape, dryrun.OneCard, mode),
                         dryrun.OneCard)
    assert one == sum(x.numel() * x.element_size()
                      for tree, _ in input_specs(cfg, shape, dryrun.OneCard,
                                                 mode).values()
                      for x in tree_leaves(tree))


def _run_cli(*args, timeout=900):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})


def test_cli_runs_every_arch_at_decode_32k_without_allocating(tmp_path):
    """``--all --shape decode_32k``: every assigned arch at full width on
    the (16, 16) mesh in its own subprocess (three at a time), exit 0; the
    ranks' arguments weigh at least the float32 parameters (10-1,270 GB)
    while the process stays under 1 GB of host memory and never
    initialises CUDA; the analytic numbers are the reference's, and the
    counted FLOPs fall within 0.5-2x of them. The sharded trace gives a
    collective term (bytes by kind, NVLink's rate) and one rank's memory,
    its arguments the argument bytes and its peak above them."""
    proc = _run_cli("--all", "--shape", "decode_32k", "--jobs", "3",
                    "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads((tmp_path / "dryrun_singlepod.json").read_text())
    assert [r["arch"] for r in results] == list(jcfgs.ASSIGNED)
    for r in results:
        assert r["ok"] and r["shape"] == "decode_32k" and r["chips"] == 256, r
        assert r["mesh"] == {"data": 16, "model": 16}
        assert not r["cuda_initialized"]
        assert r["host_peak_rss_gb"] < 1.0, r
        cfg = tcfgs.get_config(r["arch"])
        assert r["argument_bytes_per_rank"] * 256 >= 4 * cfg.param_count(), r
        assert 0.5 < r["counted_over_analytic"] < 2.0, r
        j = jroof.analyze(jcfgs.get_config(r["arch"]),
                          jcfgs.INPUT_SHAPES["decode_32k"], {}, "", 256)
        assert r["flops_per_chip"] == j["flops_per_chip"]
        assert r["hbm_bytes_per_chip"] == j["hbm_bytes_per_chip"]
        assert r["model_flops_total"] == j["model_flops_total"]
        assert r["useful_flops_ratio"] == pytest.approx(j["useful_flops_ratio"])
        coll = r["collectives"]
        assert coll and set(coll) <= {"all-reduce", "all-gather",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute"}, r
        assert r["collective_bytes_per_chip"] == sum(coll.values()) > 0
        assert r["t_collective_s"] == pytest.approx(
            r["collective_bytes_per_chip"] / roofline.LINK_BW)
        m = r["memory"]
        assert m["argument_bytes"] == r["argument_bytes_per_rank"], r
        assert m["peak_bytes"] >= m["argument_bytes"] + m["output_bytes"]
    assert "10/10 combos traced" in proc.stderr


def test_cli_multi_pod_mesh_and_refusals():
    """``--multi-pod`` builds the (2, 16, 16) mesh of 512 fake ranks;
    ``--hlo-out`` is refused with a message, and a run without a
    combination asks for one."""
    proc = _run_cli("--arch", "musicgen-large", "--shape", "long_500k",
                    "--multi-pod", "--profile", "optimized")
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["mesh"] == {"pod": 2, "data": 16, "model": 16} and r["chips"] == 512
    assert r["multi_pod"] and r["profile"] == "optimized"
    # batch 1 replicates over the data axes; bf16 params over model only
    assert r["argument_bytes_per_rank"] < 1e9
    proc = _run_cli("--arch", "yi-9b", "--shape", "decode_32k", "--hlo-out", "x")
    assert proc.returncode == 1 and "Traceback" not in proc.stderr
    assert "--hlo-out has no counterpart" in proc.stderr
    proc = _run_cli()
    assert proc.returncode == 1 and "pass --arch and --shape" in proc.stderr


def test_production_mesh_in_a_subprocess():
    """``make_production_mesh`` returns DeviceMeshes of the reference's
    shapes and axis names over the fake backend, in a process of its own
    (installing the group is process-wide), and refuses a second mesh of
    another size."""
    code = (
        "from repro_torch.launch.mesh import make_production_mesh, mesh_axes\n"
        "m = make_production_mesh()\n"
        "print(tuple(m.shape), m.mesh_dim_names, mesh_axes(m))\n"
        "try:\n"
        "    make_production_mesh(multi_pod=True)\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "(16, 16) ('data', 'model') (('data',), 'model')"
    assert lines[1].startswith("refused: a process group of 256 ranks")

"""MoE's mesh paths of the port (``models.moe.moe_ffn`` with a mesh in
``sharding.context``) on 8 CPU ranks, against the reference on its own
8-device mesh.

The reference test's config (d 32, E 4, top-2, cf 8.0) and params (its
``init_moe`` from key 0, carried across by the bridge) on a (data 4, model
2) mesh: the baseline ZeRO-gather region, the optimized profile (at the
reference test's 32 tokens, 8 a data shard, it takes the weight-stationary
path; at 320 the ZeRO-gather one), the weight-stationary path at one token
a row (``x[:, :1]``), the fallback to no data split where the data axis
does not divide the batch (B 2 on data 4, both profiles), and cf 1.25 with
tokens alike enough that assignments drop in every data shard. The
reference runs in a subprocess with 8 forced host devices (the device
count must not leak into this process), the port in 8 gloo processes
(``torch_moe_ranks.py``): plain tensors where the batch splits, DTensors
where it does not. Each case's y is held within 2e-4 and its aux within
1e-5 of the same-mesh reference (not of the global aux, which a data
split changes by design), y within 2e-4 of the port's path without a mesh
where nothing drops, and the region's collective result bytes by kind on
rank 0 equal to the reference's ``parse_collective_bytes`` of the
compiled region.
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

from repro_torch.bridge import _convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import moe_ffn
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="m", arch_type="moe", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=1, d_ff=64, vocab_size=32, num_experts=4,
           num_experts_per_tok=2, moe_capacity_factor=8.0)
# name -> (profile, capacity factor, input, DTensor inputs)
CASES = {
    "baseline": ("baseline", 8.0, "x", False),
    "optimized": ("optimized", 8.0, "x", False),
    "optimized_zero_gather": ("optimized", 8.0, "x_long", False),
    "weight_stationary": ("optimized", 8.0, "x_1", False),
    "fallback": ("baseline", 8.0, "x_b2", True),
    "fallback_weight_stationary": ("optimized", 8.0, "x_b2", True),
    "dropping": ("baseline", 1.25, "x_alike", False),
}
Y_TOL, AUX_TOL = 2e-4, 1e-5

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs.base import ModelConfig
    from repro.launch.roofline import parse_collective_bytes
    from repro.models.moe import init_moe, moe_ffn
    from repro.sharding import context

    cfg_kw, cases, inp, out = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    cfg = ModelConfig(**cfg_kw)
    data = np.load(inp)
    params = {k: jnp.asarray(data[k]) for k in ("router", "w_gate", "w_up",
                                                "w_down")}
    xs = {k: jnp.asarray(data[k]) for k in ("x", "x_1", "x_b2", "x_long",
                                            "x_alike")}
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    arrays, coll = {}, {}
    for name, (profile, cf, xname, _) in cases.items():
        c = cfg.replace(moe_capacity_factor=cf)
        context.set_mesh(mesh, ("data",), "model", profile=profile)
        fn = jax.jit(lambda p, xx: moe_ffn(p, xx, c))
        y, aux = fn(params, xs[xname])
        coll[name] = parse_collective_bytes(
            fn.lower(params, xs[xname]).compile().as_text())[0]
        arrays["y_" + name] = np.asarray(y)
        arrays["aux_" + name] = np.asarray(aux)
    np.savez(out, **arrays)
    print(json.dumps(coll))
""")


def inputs():
    """The reference's ``init_moe`` params from key 0 and the cases'
    inputs, drawn here (one host device is enough) as numpy arrays."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JConfig
    from repro.models.moe import init_moe
    params, _ = init_moe(jax.random.PRNGKey(0), JConfig(**CFG), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32))
    common = jax.random.normal(jax.random.PRNGKey(3), (1, 1, 32))
    xs = {"x": x, "x_1": x[:, :1], "x_b2": x[:2],
          "x_long": jax.random.normal(jax.random.PRNGKey(2), (4, 80, 32)),
          "x_alike": common + 0.3 * jax.random.normal(jax.random.PRNGKey(4),
                                                      (4, 64, 32))}
    return {k: np.asarray(v) for k, v in {**params, **xs}.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's arrays and collective bytes, and each port rank's
    results: {"ref": npz, "coll": {case: {kind: bytes}}, "ranks": [8]}.
    The reference's subprocess and the 8 ranks run side by side on the
    same inputs."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    data = inputs()
    port_cases = [{"name": k, "profile": p, "x": xn, "dtensor": dt,
                   "cfg": {**CFG, "moe_capacity_factor": cf}}
                  for k, (p, cf, xn, dt) in CASES.items()]
    np.savez(tmp / "in.npz", cases=json.dumps(port_cases), **data)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CFG),
         json.dumps({k: list(v) for k, v in CASES.items()}),
         str(tmp / "in.npz"), str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_moe_ranks.py"), str(r),
         "8", str(tmp / "store"), str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(8)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    ref_out, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-3000:]
    assert all(p.returncode == 0 for p in procs), errs
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(8)]
    return {"ref": {**data, **np.load(tmp / "ref.npz")},
            "coll": json.loads(ref_out.strip().splitlines()[-1]), "ranks": ranks}


def port_y(runs, name):
    """The port's y assembled from the ranks: a split batch's data shards
    in order; every rank of one data index (and of a replicated batch)
    must hold the same rows."""
    by_data = {}
    for r in runs["ranks"]:
        di, _ = r["coord"]
        y = np.asarray(r["cases"][name]["y"], dtype=np.float32)
        if di in by_data:
            np.testing.assert_array_equal(by_data[di], y)
        by_data[di] = y
    if CASES[name][3]:                   # replicated batch: one copy
        assert all(np.array_equal(by_data[0], v) for v in by_data.values())
        return by_data[0]
    return np.concatenate([by_data[i] for i in sorted(by_data)])


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_path_equals_the_same_mesh_reference(runs, name):
    """y within 2e-4, aux within 1e-5 of the reference's same-mesh
    results, aux equal on every rank."""
    want_y, want_aux = runs["ref"]["y_" + name], runs["ref"]["aux_" + name]
    got = port_y(runs, name)
    assert got.shape == want_y.shape
    assert np.abs(got - want_y).max() < Y_TOL, np.abs(got - want_y).max()
    auxes = {r["cases"][name]["aux"] for r in runs["ranks"]}
    assert len(auxes) == 1
    assert abs(auxes.pop() - float(want_aux)) < AUX_TOL


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[1] == 8.0])
def test_mesh_path_equals_the_path_without_a_mesh(runs, name):
    """Nothing drops at cf 8.0, so each data shard's own capacity changes
    nothing: y within 2e-4 of the port's ``moe_ffn`` without a mesh on
    the whole batch."""
    data = runs["ref"]
    params = _convert({k: data[k] for k in ("router", "w_gate", "w_up",
                                            "w_down")}, "cpu", torch.float32)
    y, _ = moe_ffn(params, torch.from_numpy(data[CASES[name][2]]),
                   ModelConfig(**CFG))
    assert np.abs(port_y(runs, name) - y.numpy()).max() < Y_TOL
    assert all(r["cases"][name]["dropped"] == 0 for r in runs["ranks"])


def test_assignments_drop_in_every_data_shard(runs):
    """At cf 1.25 tokens that route alike overflow their experts: every
    rank drops assignments of its own shard (so the per-shard capacity is
    what the comparison with the reference holds)."""
    assert all(r["cases"]["dropping"]["dropped"] > 0 for r in runs["ranks"])


@pytest.mark.parametrize("name", list(CASES))
def test_region_collective_bytes_equal_the_references(runs, name):
    """Rank 0's collective result bytes of the region by kind against the
    reference's ``parse_collective_bytes`` of its compiled region."""
    got = runs["ranks"][0]["cases"][name]["collectives"]
    want = runs["coll"][name]
    assert got == want, (got, want)

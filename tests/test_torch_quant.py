"""The port's weight quantization, its quantized matmul's plain version,
AWQ calibration, the bridge and checkpoints of quantized parameters, and
the modeled decode bytes, against the reference on the same numpy inputs.

Quantization must give the reference's bits exactly (q, scale and the AWQ
pre-scale): absmax is exact, float32 division is IEEE on both sides and
both round half to even. The plain ``dequant_matmul`` is held to the
reference's Pallas kernel in interpret mode within 1e-5 of the output's
scale (float32 sums in another order); activation stats within 1e-5
relative (float32 forwards in another order)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.checkpoint import io as jio
from repro.configs import llama2_7b_chat as jllama
from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul as jquant_matmul
from repro.models import Model as JModel
from repro.quant import calib as jcalib
from repro.quant import qweight as jqw
from repro.quant import roofline as jroof
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import io as tio
from repro_torch.configs import QuantConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops, ref
from repro_torch.models.model import Model as TModel
from repro_torch.quant import QWeight, calib, qweight, roofline
from torch_parity import port_config, tensor

REL = 1e-5          # float32 on both sides: only the order of sums differs
CFG = jcfgs.reduced(jllama.CONFIG).replace(dtype="float32")
LAYOUTS = [(8, 0), (4, 32), (4, 64), (4, 128)]


def rng_weight(seed, K=256, N=96):
    return np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)


def act_amax(seed, K):
    return np.abs(np.random.default_rng(seed).normal(size=K) * 3).astype(np.float32)


def assert_same_qweight(t, j):
    """Port QWeight against a reference QWeight: the same bits."""
    assert (t.bits, t.group) == (j.bits, j.group)
    assert t.q.dtype == {8: torch.int8, 4: torch.uint8}[t.bits]
    assert np.array_equal(t.q.cpu().numpy(), np.asarray(j.q))
    assert np.array_equal(t.scale.cpu().numpy(), np.asarray(j.scale))
    assert (t.pre is None) == (j.pre is None)
    if t.pre is not None:
        assert np.array_equal(t.pre.cpu().numpy(), np.asarray(j.pre))
    assert t.nbytes() == j.nbytes()


@pytest.mark.parametrize("awq", [False, True], ids=["absmax", "awq"])
@pytest.mark.parametrize("bits,group", LAYOUTS)
def test_quantize_weight_bit_identical(bits, group, awq):
    w = rng_weight(bits + group)
    amax = act_amax(1, w.shape[0]) if awq else None
    j = jqw.quantize_weight(w, bits=bits, group=group, act_amax=amax)
    t = qweight.quantize_weight(torch.from_numpy(w), bits=bits, group=group,
                                act_amax=amax)
    assert_same_qweight(t, j)
    np.testing.assert_array_equal(qweight.dequantize(t).numpy(),
                                  np.asarray(jqw.dequantize(j)))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [5, 130])                 # no multiple of the tile
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 32), (4, 64)])
def test_plain_dequant_matmul_matches_interpret_kernel(bits, group, M, x_dtype):
    K, N = 384, 160
    w = rng_weight(7, K, N)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    for amax in (None, act_amax(2, K)):                  # without / with pre
        j = jqw.quantize_weight(w, bits=bits, group=group, act_amax=amax)
        t = qweight.quantize_weight(torch.from_numpy(w), bits=bits,
                                    group=group, act_amax=amax)
        jx = jnp.asarray(x).astype(x_dtype)
        tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
        xs = x if amax is None else np.array(
            (jx * j.pre.astype(jx.dtype)).astype(jnp.float32))
        got = ops.dequant_matmul(tx, t).numpy()
        want = np.asarray(jops.dequant_matmul(jx, j))       # interpret mode
        assert jops._interpret()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)
        kernel = np.asarray(jquant_matmul(jnp.asarray(xs), j.q, j.scale,
                                          bits=bits, group=group,
                                          interpret=True))
        oracle = np.asarray(jref.ref_quant_matmul(jnp.asarray(xs), j.q,
                                                  j.scale, bits, group))
        plain = ref.ref_quant_matmul(torch.from_numpy(xs), t.q, t.scale, bits,
                                     group).numpy()
        np.testing.assert_allclose(plain, kernel, rtol=0, atol=REL * scale)
        np.testing.assert_allclose(plain, oracle, rtol=0, atol=REL * scale)
    assert all(n == 0 for n in ops.LAUNCHES.values())    # CPU: plain version


def test_ref_dequant_unpacks_the_reference_layout():
    for bits, group in LAYOUTS:
        j = jqw.quantize_weight(rng_weight(3), bits=bits, group=group)
        got = ref.ref_dequant(tensor(j.q), tensor(j.scale), bits, group)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jref.ref_dequant(j.q, j.scale, bits, group)))


# ------------------------------------------------------ calibration

def port_key(jkey):
    """The reference's key path over its unstacked tree -> the port's."""
    m = re.match(r"\['groups'\]\[(\d+)\]\[0\](.*)", jkey)
    return f"['layers'][{m[1]}]{m[2]}" if m else jkey


@pytest.fixture(scope="module")
def reference():
    jm = JModel(CFG)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = TModel(port_config(jm.cfg), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    calib_tokens = np.random.default_rng(4).integers(
        3, CFG.vocab_size, (10, 16)).astype(np.int32)
    jstats = jcalib.collect_act_stats(jcalib.unstack_groups(jp, CFG), CFG,
                                      calib_tokens)
    return jm, jp, tm, tp, calib_tokens, jstats


def test_collect_act_stats_matches_reference(reference):
    jm, jp, tm, tp, calib_tokens, jstats = reference
    tstats = calib.collect_act_stats(tp, tm.cfg, calib_tokens)
    assert set(tstats) == {port_key(k) for k in jstats}
    assert len(tstats) == 7 * CFG.num_layers + 1       # every matmul + lm head
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[port_key(k)], v, rtol=REL, atol=1e-6)


@pytest.mark.parametrize("weights,group", [("int8", 64), ("int4", 64),
                                           ("int4", 96)])
def test_quantize_params_with_reference_stats_bit_identical(reference, weights,
                                                            group):
    """Given the reference's activation stats, every quantized leaf equals
    the reference's after the bridge (group 96 divides no K of 128 and 256:
    _fit_group picks 64)."""
    jm, jp, tm, tp, calib_tokens, jstats = reference
    jq = jcalib.quantize_params(jm, jp, JQuantConfig(weights=weights,
                                                     group_size=group),
                                calib_tokens=calib_tokens)
    bridged = params_from_jax(jax.tree.map(np.asarray, jq), tm.cfg, "cpu")
    tq = calib.quantize_params(tm, tp, QuantConfig(weights=weights,
                                                   group_size=group),
                               stats={port_key(k): v for k, v in jstats.items()})
    got = dict(calib.named_leaves(tq))
    want = dict(calib.named_leaves(bridged))
    assert set(got) == set(want)
    n_q = 0
    for path, leaf in got.items():
        if isinstance(leaf, QWeight):
            assert leaf.pre is not None
            assert_same_qweight(leaf, want[path])
            n_q += 1
        else:
            assert torch.equal(leaf, want[path]), path
    assert n_q == 7 * CFG.num_layers + 1


def test_bridge_reads_a_save_quantized_npz(reference, tmp_path):
    jm, jp, tm, tp, calib_tokens, jstats = reference
    jq = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int4",
                                                     group_size=32),
                                calib_tokens=calib_tokens)
    path = tmp_path / "q.npz"
    jio.save_quantized(str(path), jq)
    with np.load(path) as data:
        from_npz = params_from_jax(dict(data), tm.cfg, "cpu")
    from_tree = params_from_jax(jax.tree.map(np.asarray, jq), tm.cfg, "cpu")
    leaves = dict(calib.named_leaves(from_npz))
    assert leaves.keys() == dict(calib.named_leaves(from_tree)).keys()
    wq = from_npz["layers"][1]["attn"]["wq"]
    assert isinstance(wq, QWeight) and wq.q.dtype == torch.uint8
    assert (wq.bits, wq.group) == (4, 32) and wq.pre is not None
    for key, leaf in calib.named_leaves(from_tree):
        other = leaves[key]
        if isinstance(leaf, QWeight):
            assert_same_qweight(other, leaf)
        else:
            assert torch.equal(other, leaf)
    # int8 keeps int8 q
    jq8 = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int8"))
    jio.save_quantized(str(path), jq8)
    with np.load(path) as data:
        from8 = params_from_jax(dict(data), tm.cfg, "cpu")
    assert from8["lm_head"].q.dtype == torch.int8 and from8["lm_head"].pre is None


def test_port_checkpoints_round_trip_and_check_layout(reference, tmp_path):
    jm, jp, tm, tp, calib_tokens, jstats = reference
    tq = calib.quantize_params(tm, tp, QuantConfig(weights="int4", group_size=32),
                               calib_tokens=calib_tokens)
    path = str(tmp_path / "port.npz")
    tio.save_quantized(path, tq)
    # a template built without calibration has no pre: it comes from the file
    like = calib.quantize_params(tm, tp, QuantConfig(weights="int4", group_size=32))
    back = tio.load_quantized(path, like)
    for (pa, a), (pb, b) in zip(calib.named_leaves(back), calib.named_leaves(tq)):
        assert pa == pb
        if isinstance(b, QWeight):
            assert b.pre is not None and torch.equal(a.pre, b.pre)
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)
    int8_like = calib.quantize_params(tm, tp, QuantConfig(weights="int8"))
    with pytest.raises(ValueError):
        tio.load_quantized(path, int8_like)
    # a plain tree, bf16 included, round-trips through save/load
    tio.save(path, tp)
    plain = tio.load(path, tp)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(calib.named_leaves(plain), calib.named_leaves(tp)))


@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int8", "int4"])
def test_decode_step_bytes_match_reference(weights):
    for arch in ("llama2-7b-chat", "llama2-chat-drafter-115m"):
        jc = jcfgs.get_config(arch)
        tc = tget_config(arch)
        assert tc.param_count() == jc.param_count()
        assert roofline.attn_layer_count(tc) == jroof.attn_layer_count(jc)
        for kv in ("bfloat16", "int8"):
            for batch, ctx in ((4, 201), (1, 0)):
                got = roofline.decode_step_bytes(tc, batch, ctx, weights, kv)
                want = jroof.decode_step_bytes(jc, batch, ctx, weights, kv)
                assert got.row() == want.row()


def test_quant_config_validates_like_the_reference():
    assert [QuantConfig(weights=w).bits for w in (None, "int8", "int4")] == [0, 8, 4]
    with pytest.raises(ValueError):
        QuantConfig(weights="int2")
    for K in (4096, 11008, 2816, 192, 130, 7):
        assert calib._fit_group(K, 64) == jcalib._fit_group(K, 64)

"""The port's model layers, prefill and decode against ``repro.models``.

Both packages get the same float32 weights (the reference's seeded init,
carried over by ``bridge.params_from_jax``) and the same numpy inputs.
Tolerance 1e-5: float32 throughout, only the order of sums differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs import llama2_7b_chat as jllama
from repro.experiments.pipeline import draft_config, target_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import Model as JModel
import repro_torch.configs as tcfgs
from repro_torch.bridge import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model as TModel
from torch_parity import TOL, port_config
from torch_parity import tensor as _t

CONFIGS = {
    "pipeline-target": target_config(),         # hd 32, G 3
    "pipeline-draft": draft_config(),           # hd 16, G 2
    "llama2-reduced": jcfgs.reduced(jllama.CONFIG),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(reference model, its params, port model, port params), float32."""
    jcfg = CONFIGS[request.param].replace(dtype="float32")
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = TModel(port_config(jcfg), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


def test_configs_equal_the_reference():
    for name, cfg in tcfgs.ARCHS.items():
        assert cfg == port_config(jcfgs.get_config(name))
    assert tcfgs.reduced(tcfgs.get_config("llama2-7b-chat")) == port_config(
        jcfgs.reduced(jllama.CONFIG))
    assert tcfgs.get_config("llama2-7b-chat").compute_dtype == torch.bfloat16


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(x, w, 1e-5)), atol=TOL, rtol=0)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(x), _t(pos), 10000.0).numpy(),
        np.asarray(jlayers.apply_rope(x, pos, 10000.0)), atol=TOL, rtol=0)
    mlp = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
           (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    np.testing.assert_allclose(
        tlayers.swiglu({n: _t(a) for n, a in mlp.items()}, _t(x)).numpy(),
        np.asarray(jlayers.swiglu(mlp, x)), atol=TOL, rtol=0)


def test_init_cache_matches_reference(pair):
    jm, _, tm, _ = pair
    jc = jm.init_cache(3, 40)["groups"][0]
    tc = tm.init_cache(3, 40)
    assert len(tc) == jm.cfg.num_layers
    for i, layer in enumerate(tc):
        for name in ("k", "v", "pos"):
            want = np.asarray(jc[name][i])
            assert layer[name].shape == want.shape
            assert np.array_equal(layer[name].numpy(), want)


def _prefill(jm, jp, tm, tp, B=2, S=20, cache_len=48):
    prompt = np.random.default_rng(1).integers(
        3, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(prompt), cache_len=cache_len)
    tl, tc = tm.prefill(tp, _t(prompt, torch.long), cache_len=cache_len)
    return prompt, (jl, jc), (tl, tc)


def _layer_caches(jc, i):
    return {n: np.asarray(jc["groups"][0][n][i]) for n in ("k", "v", "pos")}


@pytest.mark.parametrize("cache_len", [48, 16])   # 16 < prompt: ring layout
def test_prefill_logits_and_cache(pair, cache_len):
    jm, jp, tm, tp = pair
    _, (jl, jc), (tl, tc) = _prefill(jm, jp, tm, tp, cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert len(tc) == jm.cfg.num_layers
    for i, layer in enumerate(tc):
        want = _layer_caches(jc, i)
        np.testing.assert_allclose(layer["k"].numpy(), want["k"], atol=TOL, rtol=0)
        np.testing.assert_allclose(layer["v"].numpy(), want["v"], atol=TOL, rtol=0)
        assert np.array_equal(layer["pos"].numpy(), want["pos"])


@pytest.mark.parametrize("T", [1, 4])
def test_decode_step_chain(pair, T):
    jm, jp, tm, tp = pair
    _, (_, jc), (_, tc) = _prefill(jm, jp, tm, tp)
    toks = np.random.default_rng(T).integers(
        3, jm.cfg.vocab_size, (2, T)).astype(np.int32)
    pos = (20 + np.arange(T))[None].repeat(2, 0).astype(np.int32)
    jl, jc2 = jm.decode_step(jp, jnp.asarray(toks), jnp.asarray(pos), jc)
    tl, tc2 = tm.decode_step(tp, _t(toks, torch.long), _t(pos, torch.long), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for i, layer in enumerate(tc2):
        want = _layer_caches(jc2, i)
        np.testing.assert_allclose(layer["k"].numpy(), want["k"], atol=TOL, rtol=0)
        assert np.array_equal(layer["pos"].numpy(), want["pos"])


@pytest.mark.parametrize("fastpath", [False, True])
def test_decode_step_tree_mask_with_slots(pair, fastpath, monkeypatch):
    """Tree-masked decode with storage slots: the port's kernel path (plain
    version on the CPU) against the reference's masked _sdpa and against
    its Pallas tree kernel in interpret mode."""
    monkeypatch.setattr(jattn, "TREE_FASTPATH", fastpath)
    jm, jp, tm, tp = pair
    _, (_, jc), (_, tc) = _prefill(jm, jp, tm, tp)
    N = 5
    toks = np.random.default_rng(7).integers(
        3, jm.cfg.vocab_size, (2, N)).astype(np.int32)
    pos = 20 + np.array([[0, 1, 1, 2, 2]] * 2, np.int32)
    slots = 20 + np.broadcast_to(np.arange(N, dtype=np.int32), (2, N))
    anc = np.array([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0], [1, 0, 1, 0, 0],
                    [1, 1, 0, 1, 0], [1, 0, 1, 0, 1]], bool)
    amask = np.ones((2, N, 48), bool)
    amask[:, :, 20:20 + N] = anc
    jl, jc2 = jm.decode_step(jp, jnp.asarray(toks), jnp.asarray(pos), jc,
                             slots=jnp.asarray(slots), attn_mask=jnp.asarray(amask))
    tl, tc2 = tm.decode_step(tp, _t(toks, torch.long), _t(pos, torch.long), tc,
                             slots=_t(slots, torch.long), attn_mask=_t(amask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for i, layer in enumerate(tc2):
        want = _layer_caches(jc2, i)
        np.testing.assert_allclose(layer["v"].numpy(), want["v"], atol=TOL, rtol=0)
        assert np.array_equal(layer["pos"].numpy(), want["pos"])

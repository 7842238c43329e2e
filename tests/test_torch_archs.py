"""The served architectures of the registry, in reduced form, against
``repro``: Yi-9B, Phi-4-mini, Minitron-4B, Chameleon-34B (qk-norm),
Gemma-2-9B (local and global layers, softcaps, scaled embeddings; its
sliding window is covered in test_torch_windows.py), the mixture-of-
experts granite-moe-3b-a800m and grok-1-314b (their layer is covered in
test_torch_moe.py), MusicGen's single-codebook variant, as both
launchers serve it, and the recurrent zamba2-7b (Mamba2 with shared
attention) and xlstm-1.3b (their layers and rounds are covered in
test_torch_recurrent.py and test_torch_hybrid.py).

Both packages get the same float32 weights (the reference's seeded init,
with Chameleon's zero-initialised qk-norm weights replaced by random ones
so that they matter, carried over by ``bridge.params_from_jax``) and the
same tokens. Logits of the training forward, of prefill and of a decode
step must agree within 2e-5 of the logits' scale: float32 on both sides,
only the order of sums differs. The port's prefill and decode must give
its own full forward's logits (the port of
``test_configs_smoke.py::test_smoke_decode_consistency``) where no MoE
layer drops an assignment: an MoE layer's capacity depends on the tokens
of the call, so where the prefill (B x S tokens) or the full forward (B x
(S + 1)) drops one, the two are different computations, and the test
holds them to the reference's own prefill and decode only. One train step
must move the parameters with a finite loss (``test_smoke_train_step``),
and greedy chain and tree speculation with the arch's drafter must give
the target's greedy tokens exactly; a recurrent arch's tree round is
refused with the reference's message."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import Model as JModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import TrainConfig
from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                          speculative_generate)
from repro_torch.models.model import Model as TModel
from repro_torch.models.transformer import layer_params
from repro_torch.spectree.round import TREE_REFUSAL, tree_speculative_generate
from repro_torch.spectree.tree import TreeSpec
from repro_torch.training import make_train_state, make_train_step
from torch_parity import (dropped_per_call, one_torch_thread,  # noqa: F401
                          port_config)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("yi-9b", "phi4-mini-3.8b", "minitron-4b", "chameleon-34b",
         "gemma2-9b", "granite-moe-3b-a800m", "grok-1-314b", "musicgen-large",
         "zamba2-7b", "xlstm-1.3b")
MIXERS = ("attn", "mamba", "mlstm", "slstm")
LOGIT_TOL = 2e-5        # of the logits' scale (max |logit|), float32
B, S, CACHE = 2, 16, 24


def reference_config(arch):
    """The reduced config both launchers serve for ``arch`` (MusicGen as
    its single-codebook variant), in float32."""
    cfg = jcfgs.reduced(jcfgs.get_config(arch))
    if cfg.num_codebooks > 1:
        cfg = cfg.replace(num_codebooks=1)
    return cfg.replace(dtype="float32")


def random_qk_norms(np_tree, seed=7):
    """The tree with every q_norm/k_norm leaf replaced by small random
    values (the init's zeros would make qk-norm's weights untested)."""
    rng = np.random.default_rng(seed)
    if isinstance(np_tree, dict):
        return {k: (0.3 * rng.standard_normal(np.shape(v)).astype(np.float32)
                    if k in ("q_norm", "k_norm") else random_qk_norms(v, seed + 1))
                for k, v in np_tree.items()}
    if isinstance(np_tree, list):
        return [random_qk_norms(v, seed + 1) for v in np_tree]
    return np_tree


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params, port model, port params, tokens)."""
    jcfg = reference_config(request.param)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    np_tree = random_qk_norms(jax.tree.map(np.asarray, jp))
    jp = jax.tree.map(jnp.asarray, np_tree)
    tm = TModel(port_config(jcfg), device="cpu")
    tp = params_from_jax(np_tree, tm.cfg, "cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def assert_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_TOL * scale, (err, scale)


def test_param_tree_matches_the_reference(pair):
    """Layer by layer, the port's tree has its init's leaves; the first
    attention layer's (zamba2: its shared set's) projections have the
    config's shapes."""
    jm, _, tm, tp, _ = pair
    cfg = tm.cfg
    assert len(tp["layers"]) == cfg.num_layers
    own = tm.init(0)
    for got, want in zip(layer_params(tp, cfg), layer_params(own, cfg)):
        assert got.keys() == want.keys()
        for mixer in set(MIXERS) & got.keys():
            assert got[mixer].keys() == want[mixer].keys()
            for name, leaf in got[mixer].items():
                assert leaf.shape == want[mixer][name].shape, name
                assert leaf.dtype == want[mixer][name].dtype, name
    attns = [lp["attn"] for lp in layer_params(tp, cfg) if "attn" in lp]
    if not attns:       # xlstm: no attention layer
        assert cfg.param_count() == jm.cfg.param_count()
        return
    attn = attns[0]
    hd = cfg.head_dim_
    assert tuple(attn["wq"].shape) == (cfg.d_model, cfg.num_heads * hd)
    assert tuple(attn["wk"].shape) == (cfg.d_model, cfg.num_kv_heads * hd)
    assert ("q_norm" in attn) == ("k_norm" in attn) == cfg.qk_norm
    if cfg.is_moe:
        moe = tp["layers"][0]["moe"]
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert "mlp" not in tp["layers"][0]
        assert tuple(moe["router"].shape) == (d, E)
        assert moe["router"].dtype == own["layers"][0]["moe"]["router"].dtype \
            == torch.float32
        assert tuple(moe["w_gate"].shape) == (E, d, f)
        assert tuple(moe["w_down"].shape) == (E, f, d)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            assert attn[name].dtype == own["layers"][0]["attn"][name].dtype \
                == torch.float32
            assert tuple(attn[name].shape) == (hd,)
            assert not own["layers"][0]["attn"][name].any()   # zeros: 1 + w
    assert cfg.param_count() == jm.cfg.param_count()


def test_logits_match_the_reference(pair):
    jm, jp, tm, tp, toks = pair
    want, _ = jm.logits(jp, jnp.asarray(toks))
    got = tm.logits(tp, torch.as_tensor(toks, dtype=torch.long))
    assert got.shape == (B, S, tm.cfg.vocab_size)
    assert_close(got, want)


def test_prefill_and_decode_match_the_reference_and_the_full_forward(pair):
    jm, jp, tm, tp, toks = pair
    t = torch.as_tensor(toks, dtype=torch.long)
    with dropped_per_call() as prefill_calls:
        lg, cache = tm.prefill(tp, t, cache_len=CACHE)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks), cache_len=CACHE)
    assert_close(lg, jlg)
    pos = np.full((B, 1), S, np.int32)
    dlg, _ = tm.decode_step(tp, t[:, :1], torch.as_tensor(pos, dtype=torch.long),
                            cache)
    jdlg, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jnp.asarray(pos),
                             jcache)
    assert_close(dlg, jdlg)
    with dropped_per_call() as full_calls:
        full = tm.logits(tp, torch.cat([t, t[:, :1]], dim=1))
    if any(n for *_, n in prefill_calls + full_calls):
        # the prefill and the full forward dropped different assignments:
        # the reference's own prefill and decode above are the check
        assert tm.cfg.is_moe
        return
    assert_close(dlg[:, 0], full[:, S].detach().numpy())
    assert_close(lg[:, 0], full[:, S - 1].detach().numpy())


def test_train_step_moves_the_parameters(pair):
    _, _, tm, _, toks = pair
    tc = TrainConfig(warmup_steps=2, total_steps=10)
    state = make_train_state(tm, 0, tc)
    t = torch.as_tensor(toks, dtype=torch.long)
    new_state, metrics = make_train_step(tm, tc)(state, t, torch.roll(t, -1, 1))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    mixer = next(m for m in MIXERS if m in state["params"]["layers"][0])
    old = state["params"]["layers"][0][mixer]
    new = new_state["params"]["layers"][0][mixer]
    for name in old:
        assert not torch.equal(old[name], new[name]), name


def test_greedy_speculation_equals_the_target_greedy_tokens(pair):
    """Chain (gamma 3) and tree (2, 2) speculation with the arch's drafter
    (its overrides on the reduced config, float32, seed 1), and with the
    target as its own drafter, at temperature 0 give the target's greedy
    tokens."""
    _, _, tm, tp, toks = pair
    draft = TModel(tm.cfg.drafter(), device="cpu")
    dp = draft.init(1)
    prompt = torch.as_tensor(toks[:, :12], dtype=torch.long)
    M = 16
    ar, _ = autoregressive_generate(tm, tp, prompt, M, temperature=0.0)
    sdc = SDConfig(gamma=3, temperature=0.0)
    recurrent = tm.cfg.arch_type in ("hybrid", "ssm")
    chain, cstats = speculative_generate(draft, tm, dp, tp, prompt, M, sdc)
    assert torch.equal(chain[:, :12 + M], ar)
    assert cstats.rounds > 0
    if recurrent:       # a tree needs a cache slot per node
        with pytest.raises(ValueError, match=re.escape(TREE_REFUSAL)):
            tree_speculative_generate(draft, tm, dp, tp, prompt, M, sdc,
                                      TreeSpec((2, 2)))
    else:
        tree, tstats = tree_speculative_generate(draft, tm, dp, tp, prompt,
                                                 M, sdc, TreeSpec((2, 2)))
        assert torch.equal(tree[:, :12 + M], ar)
        assert tstats.rounds > 0
    # a random drafter is never accepted at temperature 0; the target as
    # its own drafter is, so these rounds commit whole drafts and paths
    chain, cstats = speculative_generate(tm, tm, tp, tp, prompt, M, sdc)
    assert torch.equal(chain[:, :12 + M], ar)
    assert cstats.tau > 3.0, cstats.tau
    if not recurrent:
        tree, tstats = tree_speculative_generate(tm, tm, tp, tp, prompt, M,
                                                 sdc, TreeSpec((2, 2)))
        assert torch.equal(tree[:, :12 + M], ar)
        assert tstats.tau > 2.0, tstats.tau


# ------------------------------------------------ qk-norm (chameleon-34b)

@pytest.fixture(scope="module")
def chameleon():
    """Reduced Chameleon's reference params (random qk norms) as a numpy
    tree, and the port's float32 model."""
    jcfg = reference_config("chameleon-34b")
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jm, random_qk_norms(jax.tree.map(np.asarray, jp)), \
        TModel(port_config(jcfg), device="cpu")


def test_qk_norms_bridge_from_a_reference_checkpoint(chameleon, tmp_path):
    """A ``.npz`` written by ``repro/checkpoint/io.py`` carries the stacked
    (layers, hd) q_norm/k_norm leaves; they come across per layer, in
    float32, equal to the pytree's, and give the same logits."""
    from repro.checkpoint import io as jio
    _, np_tree, tm = chameleon
    path = str(tmp_path / "chameleon.npz")
    jio.save(path, np_tree)
    with np.load(path) as f:
        flat = dict(f)
    assert any("q_norm" in k for k in flat) and any("k_norm" in k for k in flat)
    from_file = params_from_jax(flat, tm.cfg, "cpu")
    from_tree = params_from_jax(np_tree, tm.cfg, "cpu")
    stacked = np_tree["groups"][0]["attn"]
    for i, layer in enumerate(from_file["layers"]):
        for name in ("q_norm", "k_norm"):
            got = layer["attn"][name]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), stacked[name][i])
            assert torch.equal(got, from_tree["layers"][i]["attn"][name])
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (2, 8)))
    assert torch.equal(tm.logits(from_file, toks), tm.logits(from_tree, toks))


def test_qk_norm_keeps_bf16_and_matches_the_reference_in_bf16(chameleon):
    """In a bf16 model qk-norm computes in float32 and casts q and k back
    to bf16 before RoPE, as the reference does: the KV cache stays bf16.
    Against the reference's ``_project_qkv`` on the same bf16 weights and
    input: within 1e-2 of the scale (bf16 keeps 8 mantissa bits, 2^-8 =
    3.9e-3 relative, and both sides round the projection, the norm and
    RoPE in turn, their sums in another order)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jm, np_tree, _ = chameleon
    jcfg = jm.cfg.replace(dtype="bfloat16")
    tm = TModel(port_config(jcfg), device="cpu")
    tp = params_from_jax(np_tree, tm.cfg, "cpu")
    la = tp["layers"][0]["attn"]
    assert la["wq"].dtype == torch.bfloat16 and la["q_norm"].dtype == torch.float32
    x = np.random.default_rng(3).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    xt = torch.as_tensor(x).bfloat16()
    q, k, v = tattn._project_qkv(la, xt, tm.cfg, torch.as_tensor(pos))
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    jla = {n: jnp.asarray(a[0]) for n, a in np_tree["groups"][0]["attn"].items()}
    jq, jk, _ = jattn._project_qkv(jla, jnp.asarray(x, jnp.bfloat16), jcfg,
                                   jnp.asarray(pos))
    for got, want in ((q, jq), (k, jk)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err
    _, cache = tm.prefill(tp, torch.as_tensor(np.zeros((2, 5), np.int64)), 8)
    assert cache[0]["k"].dtype == torch.bfloat16


def test_qk_norm_paged_continuous_equals_static(chameleon):
    """Temperature 0, 4 requests of different lengths through 2 slots of
    the paged pool, chain and tree: the static chain engine's tokens."""
    from repro_torch.serving import (ContinuousEngine, Request, ServeRequest,
                                     ServingEngine)
    _, np_tree, tm = chameleon
    tp = params_from_jax(np_tree, tm.cfg, "cpu")
    draft = TModel(tm.cfg.drafter(), device="cpu")
    dp = draft.init(1)
    rng = np.random.default_rng(4)
    lens, news = (6, 12, 8, 10), (8, 6, 10, 7)
    prompts = [rng.integers(3, 512, n).astype(np.int64) for n in lens]
    sdc = SDConfig(gamma=3, temperature=0.0)
    static = {r.request_id: r.tokens for r in ServingEngine(
        target=tm, target_params=tp, draft=draft, draft_params=dp,
        sd=sdc).serve([Request(prompt=p, max_new_tokens=m, request_id=i)
                       for i, (p, m) in enumerate(zip(prompts, news))])}
    for tree in (None, TreeSpec((2, 2))):
        engine = ContinuousEngine(
            target=tm, target_params=tp, draft=draft, draft_params=dp, sd=sdc,
            tree=tree, max_batch=2, page_size=8, prefill_chunk=8,
            max_seq_len=max(lens) + max(news))
        got = {r.request_id: r.tokens for r in engine.serve(
            [ServeRequest(prompt=p, max_new_tokens=m, request_id=i)
             for i, (p, m) in enumerate(zip(prompts, news))])}
        assert engine.telemetry.max_queue_depth >= 1     # staggered admission
        for i in static:
            np.testing.assert_array_equal(got[i], static[i])


def test_int8_weights_leave_the_qk_norms_in_float32(chameleon):
    from repro_torch.configs.base import QuantConfig
    from repro_torch.quant import cast_unquantized, quantize_params
    from repro_torch.quant.qweight import QWeight
    _, np_tree, tm = chameleon
    tp = params_from_jax(np_tree, tm.cfg, "cpu")
    qp = cast_unquantized(quantize_params(tm, tp, QuantConfig(weights="int8")),
                          torch.bfloat16)
    for layer, src in zip(qp["layers"], tp["layers"]):
        assert isinstance(layer["attn"]["wq"], QWeight)
        for name in ("q_norm", "k_norm"):
            assert layer["attn"][name].dtype == torch.float32
            assert torch.equal(layer["attn"][name], src["attn"][name])
    logits = tm.logits(qp, torch.as_tensor(np.arange(3, 11)[None]))
    assert torch.isfinite(logits).all()

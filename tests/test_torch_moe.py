"""The mixture-of-experts layer (``repro_torch.models.moe``) and the MoE
archs (granite-moe-3b-a800m, grok-1-314b) against ``repro``, on the CPU
in float32.

Both packages get the same weights (the reference's seeded init carried
over by ``bridge.params_from_jax``) and the same seeded numpy inputs.
Layer outputs and gradients must agree within 1e-5 of their scale (only
the order of sums differs), the routing and the dropped (token, expert)
assignments must be equal, and so must decoded tokens.

A layer drops the assignments past its capacity C = ceil(N * k / E * cf)
(rounded up to a multiple of 8), which depends on the N tokens of the
call, so a token's output depends on its batchmates wherever an
assignment drops: greedy speculative tokens are held to the autoregressive
ones only at ``moe_capacity_factor = E / k`` (C >= N, nothing drops), and
at the configs' own 1.25 to the reference's tokens, dropped set and all.
The routers' top-k choices have no ties on these inputs (checked), since
``torch.topk`` and ``jax.lax.top_k`` need not break one the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.checkpoint import io as jio
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import losses as jlosses
from repro.core import speculative as jspec
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import init_opt_state as jinit_opt
from repro.quant import calib as jcalib
from repro.quant import roofline as jroofline
from repro.training.finetune import make_distill_step as jmake_distill_step
from repro.training import pretrain as jpt
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import QuantConfig, TrainConfig
from repro_torch.core import speculative as tspec
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model as TModel
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.quant import calib as tcalib
from repro_torch.quant import cast_unquantized, roofline as troofline
from repro_torch.quant.qweight import QWeight
from repro_torch.serving import ContinuousEngine, ServeRequest
from repro_torch.spectree.round import tree_speculative_generate
from repro_torch.spectree.tree import TreeSpec
from repro_torch.training.finetune import (_distill_parts_and_grads,
                                           make_distill_step)
from repro_torch.training import pretrain as tpt
from torch_parity import (dropped_per_call, one_torch_thread,  # noqa: F401
                          port_config, tensor)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5           # of the output's (or gradient's) scale, float32
MOE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b")
KEY = jax.random.PRNGKey(0)
# a batch whose chain verify passes (4 rows x gamma 5 + 1) drop
# assignments in the reduced archs at cf 1.25 (the test counts them)
SPEC_B, SPEC_P, SPEC_GAMMA, SPEC_NEW = 4, 12, 5, 16


def reduced_f32(arch, **over):
    """The reduced arch in float32 (weights of a model under training in
    float32 too), with ``over``."""
    return jcfgs.reduced(jcfgs.get_config(arch)).replace(
        dtype="float32", param_dtype="float32", opt_state_dtype="float32",
        **over)


def no_drops_cf(cfg):
    """The capacity factor E / k: C >= N in every call."""
    return cfg.num_experts / cfg.num_experts_per_tok


def close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


# ------------------------------------------------------------ the layer

def layer_pair(cfg):
    """The reference's ``init_moe`` weights (float32) for both packages."""
    jp, _ = jmoe.init_moe(KEY, cfg, jnp.float32)
    tp = {k: tensor(np.asarray(v)) for k, v in jp.items()}
    return jp, tp


def tiny_cfg(cf):
    """The config of the reference's own MoE tests."""
    return JConfig(
        name="m", arch_type="moe", num_layers=1, d_model=16, num_heads=2,
        num_kv_heads=1, d_ff=32, vocab_size=32, num_experts=4,
        num_experts_per_tok=2, moe_capacity_factor=cf)


def layer_input(n, d, seed=1, shared=0.0):
    """(n, d) standard normal rows plus ``shared`` times one common row:
    hidden states with a common direction route unevenly, so that some
    expert overflows at cf 1.25."""
    rng = np.random.default_rng(seed)
    common = shared * rng.standard_normal((1, d))
    return (common + rng.standard_normal((n, d))).astype(np.float32)


def test_moe_local_matches_dense_when_no_drops():
    """The port of tests/test_models.py's test: with generous capacity the
    sort-based dispatch equals the dense oracle (its tolerances)."""
    cfg = tiny_cfg(4.0)
    _, tp = layer_pair(cfg)
    x = tensor(layer_input(24, 16))
    y1, a1 = tmoe._moe_local(tp, x, cfg)
    y2, a2 = tmoe._moe_dense(tp, x, cfg)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=0)
    torch.testing.assert_close(a1, a2, atol=1e-5, rtol=0)


def test_moe_capacity_drops_tokens():
    """The port of tests/test_models.py's test: at capacity factor 0.1 the
    dispatch drops assignments, so it differs from the dense oracle."""
    cfg = tiny_cfg(0.1)
    _, tp = layer_pair(cfg)
    x = tensor(layer_input(64, 16))
    y1, _ = tmoe._moe_local(tp, x, cfg)
    y2, _ = tmoe._moe_dense(tp, x, cfg)
    assert not torch.allclose(y1, y2, atol=1e-3)
    assert torch.isfinite(y1).all()


def assert_no_topk_tie(x, router, k):
    """The k+1 largest router probabilities of every row are distinct, so
    both packages' top-k choices are the same set in the same order."""
    logits = x.astype(np.float64) @ np.asarray(router, np.float64)
    top = -np.sort(-logits, axis=-1)[:, :k + 1]
    assert np.diff(top, axis=-1).max() < -1e-4


def test_route_matches_the_reference():
    cfg = reduced_f32("granite-moe-3b-a800m")
    jp, tp = layer_pair(cfg)
    x = layer_input(64, cfg.d_model)
    assert_no_topk_tie(x, jp["router"], cfg.num_experts_per_tok)
    jg, je, ja = jmoe._route(jnp.asarray(x), jp["router"],
                             cfg.num_experts_per_tok)
    tg, te, ta = tmoe._route(tensor(x), tp["router"], cfg.num_experts_per_tok)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close(tg, jg)
    close(ta, ja)


def first_come_keep(experts, E, C):
    """(N, k) bool: an assignment is kept when fewer than C assignments to
    its expert come before it in token-major order."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(experts.shape, bool)
    for n, row in enumerate(experts):
        for j, e in enumerate(row):
            keep[n, j] = seen[e] < C
            seen[e] += 1
    return keep


@pytest.mark.parametrize("cf", [1.25, 0.1])
def test_moe_ffn_matches_the_reference_with_the_same_drops(cf):
    """``moe_ffn`` on (2, 32) tokens of reduced granite's widths: the
    output and aux within 1e-5 of scale, and the same dropped set. The
    reference's dropped set is the first-come rule on its own routing:
    its output equals the gated sum of the kept assignments' expert
    outputs (its dense oracle's per-expert outputs). Both factors drop."""
    cfg = reduced_f32("granite-moe-3b-a800m", moe_capacity_factor=cf)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    jp, tp = layer_pair(cfg)
    x = layer_input(64, cfg.d_model, shared=0.5)
    assert_no_topk_tie(x, jp["router"], k)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x.reshape(2, 32, -1)), cfg)
    ty, taux = tmoe.moe_ffn(tp, tensor(x.reshape(2, 32, -1)), cfg)
    close(ty, jy)
    close(taux, jaux)
    C = tmoe.capacity(64, cfg)
    gates, experts, _ = jmoe._route(jnp.asarray(x), jp["router"], k)
    keep = first_come_keep(np.asarray(experts), E, C)
    assert (~keep).sum() > 0
    all_out = np.asarray(jmoe._expert_ffn(
        jp["w_gate"], jp["w_up"], jp["w_down"],
        jnp.broadcast_to(jnp.asarray(x), (E,) + x.shape)))     # (E, N, d)
    kept = np.asarray(gates) * keep
    want = np.einsum("nj,njd->nd", kept, all_out[np.asarray(experts),
                                                  np.arange(64)[:, None]])
    close(np.asarray(jy).reshape(64, -1), want)
    slot = tmoe._dispatch(tensor(np.asarray(experts)), E, C)
    np.testing.assert_array_equal((slot < E * C).numpy().reshape(64, k), keep)


def test_moe_gradients_match_jax_grad():
    """Gradients of sum(y * r) + 0.37 aux with respect to x and every
    weight, at cf 1.25 with drops, and of the aux alone (it flows through
    the mean probabilities only: the routed fractions are one-hot counts),
    against ``jax.grad``, within 1e-5 of each gradient's scale."""
    cfg = reduced_f32("granite-moe-3b-a800m")
    jp, tp = layer_pair(cfg)
    x = layer_input(64, cfg.d_model, shared=0.5)
    r = layer_input(64, cfg.d_model, seed=3)
    with dropped_per_call() as calls:
        tmoe._moe_local(tp, tensor(x), cfg)
    assert calls[0][2] > 0

    def jloss(p, xx, w_aux, w_y):
        y, aux = jmoe._moe_local(p, xx, cfg)
        return w_y * jnp.sum(y * r) + w_aux * aux

    for w_aux, w_y in ((0.37, 1.0), (1.0, 0.0)):
        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x), w_aux,
                                                   w_y)
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        xx = tensor(x).requires_grad_()
        y, aux = tmoe._moe_local(p, xx, cfg)
        (w_y * (y * tensor(r)).sum() + w_aux * aux).backward()
        close(xx.grad, jgx)
        for name in p:
            if w_y == 0.0 and name != "router":
                assert not p[name].grad.any(), name       # aux: router only
                continue
            close(p[name].grad, jgp[name])


# ------------------------------------------------------------ the archs

def arch_pair(arch, key=KEY, **over):
    """(reference model, its params, port model, port params) of the
    reduced arch in float32 with the same weights, drawn from ``key``."""
    jcfg = reduced_f32(arch, **over)
    jm = JModel(jcfg)
    jp, _ = jm.init(key)
    tm = TModel(port_config(jcfg), "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_ce_and_a_pretrain_step_match_the_reference(arch):
    """``loss_ce`` = CE + 0.01 aux with its parts, and one AdamW pretrain
    step on the same weights and batch: loss, CE, aux and every new
    parameter, float32 master weights on both sides."""
    jm, jp, tm, tp = arch_pair(arch)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jloss, jparts = jm.loss_ce(jp, jnp.asarray(toks), jnp.asarray(labels))
    tloss, tparts = tm.loss_ce(tp, tensor(toks, torch.long),
                               tensor(labels, torch.long))
    assert float(tparts["aux"]) > 0.0
    for got, want in ((tloss, jloss), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        assert abs(float(got) - float(want)) <= REL * abs(float(want))
    np.testing.assert_allclose(
        float(tloss), float(tparts["ce"]) + 0.01 * float(tparts["aux"]),
        rtol=1e-6)
    tc = dict(warmup_steps=1, total_steps=10, learning_rate=1e-4)
    jstate = {"params": jp, "opt": jinit_opt(jp)}
    jnew, jm_ = jax.jit(jpt.make_train_step(jm, JTrainConfig(**tc)))(
        jstate, jnp.asarray(toks), jnp.asarray(labels))
    tnew, tm_ = tpt.make_train_step(tm, TrainConfig(**tc))(
        {"params": tp, "opt": init_opt_state(tp)}, tensor(toks, torch.long),
        tensor(labels, torch.long))
    for name in ("loss", "ce", "aux"):
        assert abs(float(tm_[name]) - float(jm_[name])) <= REL * abs(float(jm_[name]))
    want = params_from_jax(jax.tree.map(np.asarray, jnew["params"]), tm.cfg,
                           "cpu")
    moved = 0
    for a, b, old in zip(tree_leaves(tnew["params"]), tree_leaves(want),
                         tree_leaves(tp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=REL, rtol=0)
        moved += not torch.equal(a, old)
    assert moved == len(tree_leaves(tp))


def test_tvdpp_step_with_an_moe_drafter_matches_the_reference():
    """Reduced granite (MoE) as the drafter of reduced granite (other
    weights): the loss (TVD++ plus 0.01 times the drafter's aux), the
    distillation loss apart, every gradient (each leaf within REL of its
    own scale, against ``jax.value_and_grad`` of the reference step's loss)
    and one step of both packages' ``make_distill_step``, metrics and new
    parameters. The losses are held within REL of max(1, |loss|), as
    ``test_torch_training.py`` holds them within 1e-5: TVD++'s value is
    near 0 by construction. No registry drafter has experts, so only this
    test runs the drafter's aux term."""
    jd, jdp, td, tdp = arch_pair("granite-moe-3b-a800m")
    jt, jtp, tt, ttp = arch_pair("granite-moe-3b-a800m",
                                 key=jax.random.PRNGKey(1))
    toks = np.random.default_rng(6).integers(
        0, jd.cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones(toks.shape, np.float32)
    assert jd.cfg.vocab_size <= 8192       # the reference's direct route

    def jloss_fn(p):
        th, _ = jt.hidden(jtp, toks)
        sh, aux = jd.hidden(p, toks)
        dl = jlosses.distill_loss(
            "tvdpp", jtfm.logits_from_hidden(p, sh, jd.cfg),
            jtfm.logits_from_hidden(jtp, jax.lax.stop_gradient(th), jt.cfg),
            mask)
        return dl + jd.cfg.router_aux_weight * aux, dl

    (jl, jdl), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jdp)
    tl, tdl, tg = _distill_parts_and_grads(
        td, tt, tdp, ttp, tensor(toks, torch.long), tensor(mask), "tvdpp",
        True)
    assert float(tl) - float(tdl) > 0.0    # the aux term is there
    for got, want in ((tl, jl), (tdl, jdl)):
        assert abs(float(got) - float(want)) <= REL * max(1.0, abs(float(want)))
    want = params_from_jax(jax.tree.map(np.asarray, jg), td.cfg, "cpu")
    assert want["layers"][0]["moe"]["router"].abs().max() > 0
    for a, b in zip(tree_leaves(tg), tree_leaves(want)):
        close(a, b.numpy())
    tc = dict(warmup_steps=1, total_steps=10, learning_rate=1e-4)
    jnew, jm_ = jax.jit(jmake_distill_step(
        jd, jt, JTrainConfig(**tc), "tvdpp"))(
        {"params": jdp, "opt": jinit_opt(jdp)}, jtp, jnp.asarray(toks),
        jnp.asarray(mask))
    tnew, tm_ = make_distill_step(
        td, tt, TrainConfig(**tc), "tvdpp", use_kernels=True)(
        {"params": tdp, "opt": init_opt_state(tdp)}, ttp,
        tensor(toks, torch.long), tensor(mask))
    for name in ("loss", "distill_loss"):
        assert abs(float(tm_[name]) - float(jm_[name])) <= REL * max(
            1.0, abs(float(jm_[name])))
    want = params_from_jax(jax.tree.map(np.asarray, jnew["params"]), td.cfg,
                           "cpu")
    for a, b in zip(tree_leaves(tnew["params"]), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=REL, rtol=0)


def spec_prompt(vocab):
    return tensor(np.random.default_rng(1).integers(
        0, vocab, (SPEC_B, SPEC_P)), torch.long)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_chain_and_tree_equal_ar_where_nothing_drops(arch):
    """At cf E / k nothing drops in any call (counted), so greedy chain
    (gamma 5) and tree (2, 2) speculation with the arch's drafter give
    the target's greedy tokens, on the batch whose verify passes drop at
    cf 1.25."""
    cfg = reduced_f32(arch)
    tm = TModel(port_config(cfg.replace(moe_capacity_factor=no_drops_cf(cfg))),
                "cpu")
    tp = tm.init(0)
    draft = TModel(tm.cfg.drafter(), "cpu")
    dp = draft.init(1)
    prompt = spec_prompt(cfg.vocab_size)
    sdc = tspec.SDConfig(gamma=SPEC_GAMMA, temperature=0.0)
    with dropped_per_call() as calls:
        ar, _ = tspec.autoregressive_generate(tm, tp, prompt, SPEC_NEW,
                                              temperature=0.0)
        chain, _ = tspec.speculative_generate(draft, tm, dp, tp, prompt,
                                              SPEC_NEW, sdc)
        tree, _ = tree_speculative_generate(draft, tm, dp, tp, prompt,
                                            SPEC_NEW, sdc, TreeSpec((2, 2)))
    assert calls and not any(n for _, _, n in calls)
    end = SPEC_P + SPEC_NEW
    assert torch.equal(chain[:, :end], ar)
    assert torch.equal(tree[:, :end], ar)


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",))
def test_chain_tokens_equal_the_reference_where_verify_drops(arch):
    """At the config's cf 1.25, on a batch whose verify passes drop
    assignments (counted in the port), greedy chain speculation gives the
    reference's tokens and acceptance: the same calls drop the same
    assignments in both packages."""
    jm, jp, tm, tp = arch_pair(arch)
    jd = JModel(jm.cfg.drafter())
    jdp, _ = jd.init(jax.random.PRNGKey(1))
    td = TModel(port_config(jd.cfg), "cpu")
    tdp = params_from_jax(jax.tree.map(np.asarray, jdp), td.cfg, "cpu")
    prompt = spec_prompt(jm.cfg.vocab_size)
    with dropped_per_call() as calls:
        ttok, tstats = tspec.speculative_generate(
            td, tm, tdp, tp, prompt, SPEC_NEW,
            tspec.SDConfig(gamma=SPEC_GAMMA, temperature=0.0))
    verify = SPEC_B * (SPEC_GAMMA + 1)
    assert sum(n for N, _, n in calls if N == verify) > 0
    jtok, jstats = jspec.speculative_generate(
        jd, jm, jdp, jp, jnp.asarray(prompt.numpy()), SPEC_NEW,
        jspec.SDConfig(gamma=SPEC_GAMMA, temperature=0.0))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.tau == jstats.tau


def test_continuous_engine_equals_static_ar_where_nothing_drops():
    """Reduced granite at cf E / k: 4 requests of different lengths
    through 2 slots of the paged pool, chain and tree, give each
    request's greedy tokens."""
    cfg = reduced_f32("granite-moe-3b-a800m")
    tm = TModel(port_config(cfg.replace(moe_capacity_factor=no_drops_cf(cfg))),
                "cpu")
    tp = tm.init(0)
    draft = TModel(tm.cfg.drafter(), "cpu")
    dp = draft.init(1)
    rng = np.random.default_rng(4)
    lens, news = (6, 12, 8, 10), (8, 6, 10, 7)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int64) for n in lens]
    greedy = {i: tspec.autoregressive_generate(
        tm, tp, tensor(p[None]), m, temperature=0.0)[0][0, len(p):].numpy()
        for i, (p, m) in enumerate(zip(prompts, news))}
    sdc = tspec.SDConfig(gamma=3, temperature=0.0)
    for tree in (None, TreeSpec((2, 2))):
        engine = ContinuousEngine(
            target=tm, target_params=tp, draft=draft, draft_params=dp, sd=sdc,
            tree=tree, max_batch=2, page_size=8, prefill_chunk=8,
            max_seq_len=max(lens) + max(news))
        got = {r.request_id: r.tokens for r in engine.serve(
            [ServeRequest(prompt=p, max_new_tokens=m, request_id=i)
             for i, (p, m) in enumerate(zip(prompts, news))])}
        assert engine.telemetry.max_queue_depth >= 1
        for i in greedy:
            np.testing.assert_array_equal(got[i], greedy[i])


# ------------------------------------------------ quantization, checkpoints

def quantized_paths(tree):
    """The key paths of the quantized leaves."""
    return {p for p, leaf in tcalib.named_leaves(tree)
            if isinstance(leaf, QWeight)}


def test_int8_quantizes_the_reference_leaves_and_keeps_the_router_float32():
    """int8 weights quantize the attention projections and the lm head,
    as the reference does (the same set of leaves through the bridge);
    the router and the (E, K, N) expert banks stay full precision, and
    ``cast_unquantized`` keeps the router in float32."""
    jm, jp, tm, tp = arch_pair("granite-moe-3b-a800m")
    jq = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int8"))
    want = quantized_paths(params_from_jax(jax.tree.map(np.asarray, jq),
                                           tm.cfg, "cpu"))
    tq = cast_unquantized(tcalib.quantize_params(tm, tp, QuantConfig(
        weights="int8")), torch.bfloat16)
    assert quantized_paths(tq) == want == {"['lm_head']"} | {
        f"['layers'][{i}]['attn']['{n}']" for i in range(tm.cfg.num_layers)
        for n in ("wq", "wk", "wv", "wo")}
    for layer in tq["layers"]:
        moe = layer["moe"]
        assert moe["router"].dtype == torch.float32
        assert all(moe[n].dtype == torch.bfloat16 and moe[n].dim() == 3
                   for n in ("w_gate", "w_up", "w_down"))
    logits = tm.logits(tq, tensor(np.arange(3, 11)[None], torch.long))
    assert torch.isfinite(logits).all()


def test_reference_npz_loads_plain_and_quantized(tmp_path):
    """``.npz`` files of ``repro/checkpoint/io.py`` (stacked (n, E, d, f)
    expert banks), plain and int4-quantized, bridge leaf for leaf as the
    pytrees do, routers in float32; a plain one gives the pytree's logits,
    and the port's own checkpoint round-trips it."""
    jm, jp, tm, tp = arch_pair("grok-1-314b")
    toks = tensor(np.random.default_rng(2).integers(0, 512, (2, 8)), torch.long)
    jq = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int4",
                                                     group_size=32))
    for name, tree, save in (("plain", jp, jio.save),
                             ("int4", jq, jio.save_quantized)):
        path = str(tmp_path / f"{name}.npz")
        np_tree = jax.tree.map(np.asarray, tree)
        save(path, np_tree)
        with np.load(path) as f:
            flat = dict(f)
        assert any(k.endswith("['moe']['w_gate']") and v.shape[1:] == (
            4, 128, 256) for k, v in flat.items())
        from_file = params_from_jax(flat, tm.cfg, "cpu")
        from_tree = params_from_jax(np_tree, tm.cfg, "cpu")
        got, want = (dict(tcalib.named_leaves(t)) for t in (from_file, from_tree))
        assert got.keys() == want.keys()
        for path_, leaf in want.items():
            if isinstance(leaf, QWeight):
                assert torch.equal(got[path_].q, leaf.q)
                assert torch.equal(got[path_].scale, leaf.scale)
            else:
                assert torch.equal(got[path_], leaf), path_
        assert from_file["layers"][1]["moe"]["router"].dtype == torch.float32
        assert isinstance(from_file["layers"][0]["attn"]["wq"], QWeight) == (
            name == "int4")
    from_file = params_from_jax(dict(np.load(str(tmp_path / "plain.npz"))),
                                tm.cfg, "cpu")
    assert torch.equal(tm.logits(from_file, toks), tm.logits(tp, toks))
    own = str(tmp_path / "port.npz")
    tio.save(own, tp)
    back = tio.load(own, tp)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tcalib.named_leaves(back), tcalib.named_leaves(tp)))


@pytest.mark.parametrize("weights", ["bfloat16", "int8", "int4"])
def test_decode_step_bytes_bill_experts_like_the_reference(weights):
    """The roofline bills routers and expert banks at ``param_dtype``,
    never at the quantized width, as the reference's does."""
    for arch in MOE_ARCHS:
        got = troofline.decode_step_bytes(
            tget_config(arch), 4, 256, weights=weights).row()
        want = jroofline.decode_step_bytes(
            jcfgs.get_config(arch), 4, 256, weights=weights)
        np.testing.assert_allclose(
            got, (want.weight_bytes, want.scale_bytes, want.kv_bytes,
                  want.total), rtol=1e-12)

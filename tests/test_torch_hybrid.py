"""zamba2's hybrid and xlstm in the port's serving, quantization and
training paths, against ``repro``, on the CPU in float32: greedy chain
speculation (the ports of ``test_speculative.py``'s recurrent cases),
draft heads on a hybrid target, int8 weights with per-set shared
attention, int8 KV caches beside recurrent states, the reference's
checkpoints, the weights the reference draws but never reads, modeled
bytes, a TVD++ step through a hybrid drafter, and the launchers.

Both packages get the same float32 weights (``test_torch_recurrent``'s
numpy draws into the reference's tree) and the same seeded inputs.
Logits, distributions and gradients must agree within the tolerance each
test states (float32: only the order of sums differs); tokens, accept
counts and quantized bytes must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jget_config
from repro.configs.base import ATTN, MAMBA, MLSTM, SLSTM
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import losses as jlosses
from repro.core import speculative as jspec
from repro.draftheads import drafter as jdrafter
from repro.draftheads import heads as jheads
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import transformer as jtfm
from repro.quant import calib as jcalib
from repro.quant import kvcache as jkv
from repro.quant import roofline as jroof
from repro_torch.bridge import head_params_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import speculative as tspec
from repro_torch.draftheads import HeadConfig, HeadDrafter
from repro_torch.launch import serve, train
from repro_torch.models.model import Model as TModel
from repro_torch.models.transformer import layer_kinds
from repro_torch.optim import tree_leaves
from repro_torch.quant import calib as tcalib
from repro_torch.quant import kvcache as tkv
from repro_torch.quant import roofline as troof
from repro_torch.quant.calib import named_leaves
from repro_torch.quant.qweight import QWeight
from repro_torch.serving.continuous import check_pageable
from repro_torch.spectree.round import TREE_REFUSAL
from repro_torch.training.finetune import distill_loss_and_grads
from test_torch_recurrent import (G, as_np, check_cache, close, jitted, pair,
                                  port_layers, round_noise, seeded_params)
from torch_parity import one_torch_thread, port_config, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 2e-5          # logits, of their scale
GRAD_REL = 1e-5     # distillation loss and gradients, of their scale


# ------------------------------------------ ports of test_speculative.py

BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
            attn_chunk=16, ssm_chunk=8, remat=False, dtype="float32")


def spec_models(target_pattern):
    """``test_speculative.py::_models`` in both packages (float32): a
    4-layer target of the pattern and a 2-layer dense drafter."""
    tcfg = JConfig(name="t", arch_type="dense", num_layers=4,
                   layer_pattern=target_pattern,
                   ssm_state_dim=16 if MAMBA in target_pattern else 0,
                   ssm_head_dim=16, **BASE)
    dcfg = JConfig(name="d", arch_type="dense", num_layers=2, **BASE)
    out = []
    for cfg, seed in ((tcfg, 0), (dcfg, 1)):
        jm = JModel(cfg)
        np_tree = seeded_params(jm, seed)
        tm = TModel(port_config(cfg), device="cpu")
        out.append((jm, jax.tree.map(jnp.asarray, np_tree), tm,
                    params_from_jax(np_tree, tm.cfg, "cpu")))
    return out


@pytest.mark.parametrize("pattern,name", [((ATTN,), "dense"),
                                          ((MAMBA, ATTN), "hybrid"),
                                          ((MLSTM, SLSTM), "xlstm")])
def test_greedy_sd_equals_target_ar(pattern, name):
    """The SD gold test: greedy chain tokens equal the target's greedy AR
    tokens; for the recurrent targets also the reference's tokens and τ
    (the dense case is held to the reference in test_torch_speculative)."""
    (jt, jtp, tt, ttp), (jd, jdp, td, tdp) = spec_models(pattern)
    prompt = np.random.default_rng(2).integers(0, 64, (3, 8)).astype(np.int32)
    sdc = tspec.SDConfig(gamma=3, temperature=0.0)
    toks, stats = tspec.speculative_generate(td, tt, tdp, ttp,
                                             tensor(prompt, torch.long), 16, sdc)
    ar, _ = tspec.autoregressive_generate(tt, ttp, tensor(prompt, torch.long),
                                          16, temperature=0.0)
    assert torch.equal(toks[:, :24], ar[:, :24]), name
    assert stats.num_blocks > 0 and 1.0 <= stats.tau <= 4.0
    if name == "dense":
        return
    jtoks, jstats = jspec.speculative_generate(
        jd, jt, jdp, jtp, jnp.asarray(prompt), 16,
        jspec.SDConfig(gamma=3, temperature=0.0))
    assert np.array_equal(toks[:, :24].numpy(), np.asarray(jtoks[:, :24]))
    assert stats.tau == jstats.tau


def test_attention_only_detection():
    """The port of ``test_speculative.py::test_attention_only_detection``;
    zamba2's shared attention counts as attention, as in the reference."""
    for pattern in ((MAMBA, ATTN), (ATTN,), (MLSTM, SLSTM), ("shared_attn",),
                    ("shared_attn", ATTN), (MAMBA, MAMBA, "shared_attn")):
        cfg = JConfig(name="x", arch_type="dense", num_layers=4,
                      layer_pattern=pattern, **BASE)
        assert tspec.attention_only(port_config(cfg)) == \
            jspec.attention_only(cfg), pattern
    for arch, want in (("zamba2-7b", False), ("xlstm-1.3b", False),
                       ("yi-9b", True)):
        assert tspec.attention_only(get_config(arch)) is want
        assert jspec.attention_only(jget_config(arch)) is want


# ------------------------------------------------ draft heads, hybrid target

@pytest.fixture(scope="module")
def eagle():
    """An EAGLE head for the hybrid target, drawn with numpy, in both
    packages: (reference drafter, its params, port drafter, port params)."""
    jt = pair("hybrid")["j"][0]
    jh = jdrafter.HeadDrafter(jheads.HeadConfig.for_target("eagle", jt.cfg))
    rng = np.random.default_rng(12)
    shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0))
    np_hp = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * (
            0.1 if "norm" in jax.tree_util.keystr(path)
            else a.shape[-2] ** -0.5)).astype(np.float32), shapes)
    th = HeadDrafter(HeadConfig.for_target("eagle", port_config(jt.cfg)))
    return jh, jax.tree.map(jnp.asarray, np_hp), th, \
        head_params_from_jax(np_hp, th.hc, "cpu")


def test_eagle_round_on_a_hybrid_target_matches_given_reference_noise(eagle):
    """A chain round at 0.7 with an EAGLE head on the hybrid target: the
    verify feeds one token a call and stacks each feed's hidden state; the
    target distributions within 1e-5, accept counts, tokens and the next
    feature equal, the target's cache rewound to the reference's. At
    temperature 0 the head's chain tokens equal the target's AR tokens."""
    jh, jhp, th, thp = eagle
    jt, jtp = pair("hybrid")["j"][:2]
    tt, ttp = pair("hybrid")["t"][:2]
    B, S, V = 3, 12, jt.cfg.vocab_size
    rng = np.random.default_rng(13)
    toks = rng.integers(3, V, (B, S)).astype(np.int32)
    pending = rng.integers(3, V, (B,)).astype(np.int32)
    _, jc, jhid = jitted(jt.prefill, "cache_len", "return_hidden")(
        jtp, jnp.asarray(toks), cache_len=S + 12, return_hidden=True)
    _, tc, thid = tt.prefill(ttp, tensor(toks, torch.long), S + 12,
                             return_hidden=True)
    close(thid, jhid)
    buf = np.zeros((B, S + 16), np.int32)
    buf[:, :S] = toks
    jst = {"tokens": jnp.asarray(buf), "lengths": jnp.full((B,), S, jnp.int32),
           "pending": jnp.asarray(pending), "t_cache": jc,
           "h_feat": jhid[:, -1]}
    tst = {"tokens": tensor(buf, torch.long),
           "lengths": torch.full((B,), S, dtype=torch.long),
           "pending": tensor(pending, torch.long), "t_cache": tc,
           "h_feat": thid[:, -1]}
    kr = jax.random.PRNGKey(9)
    jsdc = jspec.SDConfig(gamma=G, temperature=0.7)
    tsdc = tspec.SDConfig(gamma=G, temperature=0.7)
    ph = jspec._cached_phased_round(jh, jt, jsdc)
    jdr = ph["draft"](jhp, jtp, jst, kr)
    jver = ph["verify"](jtp, jst, jdr)
    jnew, jn = ph["commit"](jst, jdr, jver, kr)
    noise = round_noise(kr, B, V)
    tdr = tspec.sd_draft_phase(th, tsdc, thp, tst, None, noise, tt, ttp)
    tver = tspec.sd_verify_phase(tt, tsdc, ttp, tst, tdr)
    close(tver["q_stack"], jver["q_stack"], 1e-5)
    close(tver["t_hid"], jver["t_hid"])
    tnew, tn = tspec.sd_commit_phase(tsdc, tst, tdr, tver, None, noise)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    for key in ("tokens", "lengths", "pending"):
        assert np.array_equal(tnew[key].numpy(), np.asarray(jnew[key])), key
    close(tnew["h_feat"], jnew["h_feat"])
    check_cache(tnew["t_cache"], jnew["t_cache"], tt.cfg)
    prompt = tensor(toks, torch.long)
    chain, stats = tspec.speculative_generate(
        th, tt, thp, ttp, prompt, 12, tspec.SDConfig(gamma=G, temperature=0.0))
    ar, _ = tspec.autoregressive_generate(tt, ttp, prompt, 12, temperature=0.0)
    assert torch.equal(chain[:, :S + 12], ar) and stats.rounds > 0


# ------------------------------------------------------------ quantization

def qweights(tree, prefix=""):
    """{path: QWeight} of a port tree."""
    if isinstance(tree, QWeight):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {}
    return {k: v for name, sub in items
            for k, v in qweights(sub, f"{prefix}/{name}").items()}


@pytest.mark.parametrize("awq", [False, True])
def test_int8_hybrid_matches_the_reference(awq, monkeypatch):
    """int8 weights of the hybrid target, plain and AWQ-calibrated: every
    shared set is quantized per set with plain absmax (no pre-scale, AWQ
    on or off), bit for bit the reference's; the lm head (the only other
    leaf quantized: a Mamba block's projections are not) takes the
    reference's AWQ pre-scale within 1e-5; and the reference's int8 model
    gives the same prefill and decode logits in both packages (its int8
    matmul through its plain oracle), within 1e-5 of scale."""
    jt, jtp = pair("hybrid")["j"][:2]
    tt, ttp = pair("hybrid")["t"][:2]
    monkeypatch.setattr(jops.qk, "quant_matmul",
                        lambda x, q, scale, *, bits, group=0, interpret=True:
                        jref.ref_quant_matmul(x, q, scale, bits, group))
    calib = np.random.default_rng(14).integers(3, 512, (4, 16)).astype(np.int32)
    jq = jcalib.quantize_params(jt, jtp, JQuantConfig(weights="int8", awq=awq),
                                calib_tokens=calib if awq else None)
    tq = tcalib.quantize_params(tt, ttp, QuantConfig(weights="int8", awq=awq),
                                calib_tokens=calib if awq else None)
    got = qweights(tq)
    want = qweights(params_from_jax(as_np(jq), tt.cfg, "cpu"))
    assert got.keys() == want.keys()
    sets = [k for k in got if k.startswith("/shared_attn")]
    assert len(sets) == 2 * 7 and set(got) - set(sets) == {"/lm_head"}
    for k in sets:
        assert got[k].pre is None and want[k].pre is None, k
        assert torch.equal(got[k].q, want[k].q), k
        assert torch.equal(got[k].scale, want[k].scale), k
    assert (got["/lm_head"].pre is not None) == awq
    if awq:
        close(got["/lm_head"].pre, want["/lm_head"].pre.numpy(), 1e-5)
    tref = params_from_jax(as_np(jq), tt.cfg, "cpu")
    toks = calib[:2, :12]
    jlg, jc = jitted(jt.prefill, "cache_len")(jq, jnp.asarray(toks),
                                              cache_len=16)
    tlg, tc = tt.prefill(tref, tensor(toks, torch.long), 16)
    close(tlg, jlg, 1e-5)
    pos = np.full((2, 1), 12, np.int32)
    jdl, _ = jitted(jt.decode_step)(jq, jnp.asarray(toks[:, :1]),
                                    jnp.asarray(pos), jc)
    tdl, _ = tt.decode_step(tref, tensor(toks[:, :1], torch.long),
                            tensor(pos, torch.long), tc)
    close(tdl, jdl, 1e-5)


def test_int8_kv_leaves_recurrent_states_alone():
    """``quantize_kv_cache`` turns the shared attention caches into int8 and
    passes every Mamba state and conv tail through, as the reference's."""
    jt, jtp = pair("hybrid")["j"][:2]
    tt, ttp = pair("hybrid")["t"][:2]
    toks = np.random.default_rng(15).integers(3, 512, (2, 12)).astype(np.int32)
    _, jc = jitted(jt.prefill, "cache_len")(jtp, jnp.asarray(toks),
                                            cache_len=16)
    _, tc = tt.prefill(ttp, tensor(toks, torch.long), 16)
    tq = tkv.quantize_kv_cache(tc)
    want = port_layers(jkv.quantize_kv_cache(jc), tt.cfg)
    for t, q, w in zip(tc, tq, want):
        assert q.keys() == w.keys()
        if "pos" not in t:
            assert all(q[k] is t[k] for k in t)
            continue
        assert q["k"].dtype == torch.int8
        assert np.array_equal(q["pos"].numpy(), w["pos"])
        for k in ("k_scale", "v_scale"):
            close(q[k], w[k], 1e-6)
        assert np.abs(q["k"].numpy().astype(int) - w["k"]).max() <= 1


def test_xlstm_int8_is_refused_where_the_reference_fails():
    """The reference quantizes an mLSTM's w_up and w_down (their names are
    in ``QUANT_WEIGHT_NAMES``) and its forward then calls ``.astype`` on a
    ``QWeight``; the port refuses to quantize such a config, naming
    ROADMAP §3 item 9."""
    jt, jtp = pair("xlstm")["j"][:2]
    tt, ttp = pair("xlstm")["t"][:2]
    jq = jcalib.quantize_params(jt, jtp, JQuantConfig(weights="int8"))
    toks = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(AttributeError, match="astype"):
        jt.prefill(jq, toks, cache_len=8)
    with pytest.raises(ValueError, match="ROADMAP §3 item 9"):
        tcalib.quantize_params(tt, ttp, QuantConfig(weights="int8"))
    # weights=None quantizes nothing, as in the reference
    assert tcalib.quantize_params(tt, ttp, QuantConfig()) is ttp


# ------------------------------------------ checkpoints and unread weights

def test_reference_checkpoints_of_the_hybrid_load(tmp_path):
    """A ``.npz`` the reference writes of the hybrid (float32, and int8 by
    ``save_quantized``) loads into the port: the same leaves as from the
    pytree, shared sets split per set, the unread shared-position blocks
    dropped."""
    jt, jtp = pair("hybrid")["j"][:2]
    tt = pair("hybrid")["t"][0]
    for name, tree, save in (
            ("plain", jtp, jio.save),
            ("int8", jcalib.quantize_params(jt, jtp, JQuantConfig(weights="int8")),
             jio.save_quantized)):
        path = str(tmp_path / f"{name}.npz")
        save(path, tree)
        with np.load(path) as f:
            from_file = params_from_jax(dict(f), tt.cfg, "cpu")
        from_tree = params_from_jax(as_np(tree), tt.cfg, "cpu")
        assert len(from_file["shared_attn"]) == 2
        assert [lp == {} for lp in from_file["layers"]] == \
            [k == "shared_attn" for k in layer_kinds(tt.cfg)]
        a, b = dict(named_leaves(from_file)), dict(named_leaves(from_tree))
        assert a.keys() == b.keys()
        assert len(qweights(from_file)) == (0 if name == "plain" else 15)
        for k, x in a.items():
            if isinstance(x, QWeight):
                assert torch.equal(x.q, b[k].q) and torch.equal(x.scale,
                                                               b[k].scale), k
            else:
                assert torch.equal(x, b[k]), k


def test_unread_shared_position_weights_are_dropped():
    """The reference's init draws an attention+MLP block at the shared
    position of every group, which its forward never reads: perturbing
    those leaves leaves its logits unchanged, and the port, which drops
    them, holds the same parameters either way. The port holds what the
    forward reads; ``param_count`` (the MBSU c of both packages) differs
    from the init's count, and from the port's (ROADMAP §3 item 10)."""
    jt, jtp = pair("hybrid")["j"][:2]
    tt = pair("hybrid")["t"][0]
    np_tree = as_np(jtp)
    k = list(jt.cfg.pattern_blocks()[0]).index("shared_attn")
    rng = np.random.default_rng(16)
    bent = jax.tree.map(lambda a: a, np_tree)
    bent["groups"] = list(bent["groups"])
    bent["groups"][k] = jax.tree.map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32),
        np_tree["groups"][k])
    toks = jnp.asarray(rng.integers(3, 512, (2, 10)).astype(np.int32))
    logits = jax.jit(lambda p: jt.logits(p, toks)[0])
    assert np.array_equal(np.asarray(logits(jtp)),
                          np.asarray(logits(jax.tree.map(jnp.asarray, bent))))
    a = params_from_jax(np_tree, tt.cfg, "cpu")
    b = params_from_jax(bent, tt.cfg, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    held = sum(t.numel() for t in tree_leaves(a))
    drawn = sum(np.size(x) for x in jax.tree.leaves(np_tree))
    unread = sum(np.size(x) for x in jax.tree.leaves(np_tree["groups"][k]))
    assert held == drawn - unread
    assert held == sum(t.numel() for t in tree_leaves(tt.init(0)))
    assert tt.cfg.param_count() == jt.cfg.param_count() != held


def test_decode_bytes_count_shared_attention():
    """Modeled decode bytes of zamba2, xlstm and their drafters equal the
    reference's: KV per shared application, weights per shared set."""
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        for jc in (jget_config(arch), jget_config(arch).drafter()):
            for weights, kv in (("bfloat16", "bfloat16"), ("int8", "int8"),
                                ("int4", "bfloat16")):
                got = troof.decode_step_bytes(port_config(jc), 4, 192,
                                              weights, kv)
                want = jroof.decode_step_bytes(jc, 4, 192, weights, kv)
                assert got.row() == pytest.approx(want.row(), rel=1e-12)
    assert troof.attn_layer_count(get_config("zamba2-7b")) == 11


# ---------------------------------------------------------- training

def test_tvdpp_step_through_a_hybrid_drafter_matches_the_reference():
    """TVD++ of the hybrid drafter against the frozen hybrid target:
    autograd through the chunked SSD scan, the causal conv and the shared
    sets; the loss and every gradient leaf within 1e-5 of the gradients'
    scale of ``jax.value_and_grad`` (the unread shared-position leaves of
    the reference, whose gradients are 0, dropped by the bridge)."""
    p = pair("hybrid")
    jt, jtp, jd, jdp = p["j"]
    tt, ttp, td, tdp = p["t"]
    toks = np.random.default_rng(17).integers(0, 512, (2, 16)).astype(np.int32)
    mask = np.ones(toks.shape, np.float32)

    def loss(dp):
        th, _ = jt.hidden(jtp, toks)
        sh, _ = jd.hidden(dp, toks)
        return jlosses.distill_loss(
            "tvdpp", jtfm.logits_from_hidden(dp, sh, jd.cfg),
            jtfm.logits_from_hidden(jtp, th, jt.cfg), mask)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jdp)
    tloss, tgrads = distill_loss_and_grads(td, tt, tdp, ttp,
                                           tensor(toks, torch.long),
                                           tensor(mask), "tvdpp", True)
    assert abs(float(tloss) - float(jloss)) < GRAD_REL
    want = params_from_jax(as_np(jgrads), td.cfg, "cpu", dtype=torch.float32)
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(as_np(jgrads)))
    got, exp = tree_leaves(tgrads), tree_leaves(want)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=GRAD_REL * scale, rtol=0)
    assert all(torch.isfinite(g).all() for g in got)


# ---------------------------------------------------------- the launchers

def test_serve_cli_serves_zamba2_by_chain_and_refuses_tree_and_paging(capsys):
    """The serve CLI runs reduced zamba2 by chain speculation; ``--tree``,
    ``--continuous`` and quantized xLSTM weights exit with the reference's
    refusals (no traceback), before a model is built."""
    serve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--max-new", "8",
                "--temperature", "0.7"])
    out = capsys.readouterr().out
    assert "arch=zamba2-7b-reduced draft=zamba2-7b-reduced-drafter" in out
    assert "served 2 requests; tau=" in out
    for flags, msg in ((["--arch", "zamba2-7b", "--tree"], TREE_REFUSAL),
                       (["--arch", "xlstm-1.3b", "--tree"], TREE_REFUSAL),
                       (["--arch", "zamba2-7b", "--continuous"],
                        "target has recurrent layers; the paged KV pool "
                        "supports attention-only models"),
                       (["--arch", "xlstm-1.3b", "--quant-weights", "int8"],
                        "ROADMAP §3 item 9")):
        with pytest.raises(SystemExit) as exc:
            serve.main(flags + ["--reduced", "--device", "cpu"])
        assert msg in str(exc.value.code), exc.value.code
    with pytest.raises(ValueError, match="attention-only"):
        check_pageable(get_config("xlstm-1.3b").drafter(), "draft")


def test_train_cli_trains_the_recurrent_archs(capsys):
    for arch, phase in (("zamba2-7b", "distill"), ("xlstm-1.3b", "pretrain")):
        train.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "32",
                    "--phase", phase])
        out = capsys.readouterr().out
        assert "step 2:" in out and "done in" in out

"""Drafter training in the port against the reference: train-mode attention
and the model's ``hidden``/``loss_ce``, AdamW and its schedule, one
pretraining and one distillation step compared parameter by parameter, the
host loops, distillation-data generation at temperature 0, and the data
pipeline.

Both sides get the same float32 weights (through ``bridge``) and the same
numpy inputs, and compute in float32: they differ only in the order of
their sums, so values and parameters after a step agree within 1e-5."""
import jax
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import datagen as jdatagen
from repro.core import losses as jlosses
from repro.data import mixing as jmix
from repro.data import packing as jpack
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.optim import adamw_update as jadamw
from repro.optim import init_opt_state as jinit_opt
from repro.optim import warmup_decay_lr as jlr
from repro.training.finetune import finetune as jfinetune
from repro.training.finetune import make_distill_step as jmake_distill_step
from repro.training import pretrain as jpt
import repro_torch.models.model as tmodel
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import datagen as tdatagen
from repro_torch.data import mixing as tmix
from repro_torch.data import packing as tpack
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model as TModel
from repro_torch.optim import (adamw_update, init_opt_state, tree_leaves,
                               warmup_decay_lr)
from repro_torch.training.finetune import (distill_loss_and_grads, finetune,
                                           make_distill_step)
from repro_torch.training import pretrain as tpt
from torch_parity import models, port_config, tensor  # noqa: F401 (fixture)

TOL = 1e-5
# The first AdamW step moves each weight by about lr * g / (|g| + eps): a
# weight whose gradient is within a few eps of 0 moves by a sizeable share
# of lr when that gradient differs in its last bits. At the paper's rate of
# 1e-4 (TrainConfig's default) such a share stays below TOL; the gradients
# themselves are compared directly too.
TC = dict(warmup_steps=1, total_steps=10, learning_rate=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(port_tree, ref_tree, cfg, tol=TOL):
    """A port parameter tree against the reference's, converted by the
    bridge to the port's layout in float32."""
    want = params_from_jax(_np(ref_tree), cfg, "cpu", dtype=torch.float32)
    got, exp = tree_leaves(port_tree), tree_leaves(want)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=tol, rtol=0)


def test_attention_hidden_and_loss_ce_match_reference(models, monkeypatch):
    jt, jtp = models["j"][:2]
    tt, ttp = models["t"][:2]
    cfg = jt.cfg
    rng = np.random.default_rng(4)
    S = 2 * cfg.attn_chunk                       # two query chunks
    x = (rng.standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jlayer = jax.tree.map(lambda a: a[0], jtp["groups"][0]["attn"])
    np.testing.assert_allclose(
        tattn.causal_attention(ttp["layers"][0]["attn"], tensor(x), tensor(pos),
                               tt.cfg).numpy(),
        np.asarray(jattn.causal_attention(jlayer, x, pos, cfg)), atol=TOL, rtol=0)

    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    tok_t = tensor(toks, torch.long)
    jh, _ = jt.hidden(jtp, toks)
    np.testing.assert_allclose(tt.hidden(ttp, tok_t).numpy(), np.asarray(jh),
                               atol=TOL, rtol=0)
    jlog, _ = jt.logits(jtp, toks)
    np.testing.assert_allclose(tt.logits(ttp, tok_t).numpy(), np.asarray(jlog),
                               atol=TOL, rtol=0)
    # four loss chunks on both sides
    monkeypatch.setattr(jmodel, "LOSS_CHUNK", S // 4)
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", S // 4)
    jloss, _ = jt.loss_ce(jtp, toks, labels)
    tloss, parts = tt.loss_ce(ttp, tok_t, tensor(labels, torch.long))
    assert abs(float(tloss) - float(jloss)) < TOL
    # a dense model's loss is its CE plus 0.01 times an aux of 0: its bits
    assert torch.equal(parts["ce"], tloss) and float(parts["aux"]) == 0.0


def test_adamw_and_schedule_match_reference():
    for step in (0, 1, 2, 5, 9, 10, 11, 50):
        args = (1e-3, 1e-5, 3, 10)
        np.testing.assert_allclose(float(warmup_decay_lr(step, *args)),
                                   float(jlr(step, *args)), rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "layers": [{"w": (5,)}, {"w": (2, 2)}]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    tc = dict(warmup_steps=1, total_steps=10, learning_rate=1e-3)
    jp, jopt = params, jinit_opt(params)
    tp = jax.tree.map(tensor, params)
    topt = init_opt_state(tp)
    for scale in (3.0, 0.1):              # global norm above, then below 1
        grads = jax.tree.map(lambda p: scale * rng.standard_normal(p.shape)
                             .astype(np.float32), params)
        jp, jopt, jinfo = jadamw(jp, grads, jopt, JTrainConfig(**tc))
        tp, topt, tinfo = adamw_update(tp, jax.tree.map(tensor, grads), topt,
                                       TrainConfig(**tc))
        for got, want in ((tp, jp), (topt["m"], jopt["m"]),
                          (topt["v"], jopt["v"])):
            for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                            jax.tree.leaves(_np(want))):
                np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-6)
        assert int(topt["step"]) == int(jopt["step"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=1e-6)


def _pair(vocab):
    """A tiny float32 (target, drafter) pair at ``vocab``, as the
    reference's tests/test_finetune_pallas.py builds it, both sides with the
    same weights and AdamW states."""
    cfg_t = JConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=vocab,
                    attn_chunk=16, remat=False, dtype="float32")
    cfg_d = cfg_t.replace(name="d", num_layers=1, d_model=32, d_ff=64)
    out = {}
    for name, cfg, seed in (("t", cfg_t, 0), ("d", cfg_d, 1)):
        jm = JModel(cfg)
        jstate = jax.jit(lambda k, jm=jm: jpt.make_train_state(
            jm, k, JTrainConfig(**TC))[0])(jax.random.PRNGKey(seed))
        tm = TModel(port_config(cfg), "cpu")
        tp = params_from_jax(_np(jstate["params"]), tm.cfg, "cpu",
                             dtype=torch.float32)
        out[name] = (jm, jstate, tm, {"params": tp, "opt": init_opt_state(tp)})
    toks = np.random.default_rng(2).integers(0, vocab, (2, 16)).astype(np.int32)
    return out, toks


def _ref_distill_loss(jd, jt, jtp, toks, mask):
    """The reference's distillation loss as a function of the drafter's
    parameters: its chunked loss above 8192, else its plain loss (which
    its own tests hold to its kernels within 1e-5)."""
    th, _ = jt.hidden(jtp, toks)
    V = jd.cfg.vocab_size

    def loss(p):
        sh, _ = jd.hidden(p, toks)
        if V > 8192:
            return jlosses.chunked_distill_loss("tvdpp", p, jtp, sh, th, mask,
                                                jd.cfg, jt.cfg)
        return jlosses.distill_loss("tvdpp", jtfm.logits_from_hidden(p, sh, jd.cfg),
                                    jtfm.logits_from_hidden(jtp, th, jt.cfg), mask)
    return loss


@pytest.mark.parametrize("vocab", [512, 8448])
def test_train_and_distill_steps_match_reference(vocab):
    """vocab 512 takes the direct route (the reference's use_pallas=True
    against the port's use_kernels=True), vocab 8448 the chunked route
    (the reference's chunked step, which runs no kernel, against the port's
    kernel route)."""
    pair, toks = _pair(vocab)
    jd, jdstate, td, tdstate = pair["d"]
    jt, jtstate, tt, ttstate = pair["t"]
    inputs, labels = jpack.shift_labels(toks)
    jnew, jm = jax.jit(jpt.make_train_step(jd, JTrainConfig(**TC)))(
        jdstate, inputs, labels)
    tnew, tm = tpt.make_train_step(td, TrainConfig(**TC))(
        tdstate, tensor(inputs, torch.long), tensor(labels, torch.long))
    assert abs(float(tm["loss"]) - float(jm["loss"])) < TOL
    _assert_trees_close(tnew["params"], jnew["params"], td.cfg)

    mask = np.ones(toks.shape, np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(_ref_distill_loss(
        jd, jt, jtstate["params"], toks, mask)))(jdstate["params"])
    tloss, tgrads = distill_loss_and_grads(td, tt, tdstate["params"],
                                           ttstate["params"],
                                           tensor(toks, torch.long),
                                           tensor(mask), "tvdpp", True)
    assert abs(float(tloss) - float(jloss)) < TOL
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(_np(jgrads)))
    _assert_trees_close(tgrads, jgrads, td.cfg, tol=TOL * scale)
    jstep = jax.jit(jmake_distill_step(jd, jt, JTrainConfig(**TC), "tvdpp",
                                       use_pallas=True))
    tstep = make_distill_step(td, tt, TrainConfig(**TC), "tvdpp",
                                  use_kernels=True)
    jnew, jm = jstep(jdstate, jtstate["params"], toks, mask)
    tnew, tm = tstep(tdstate, ttstate["params"], tensor(toks, torch.long),
                     tensor(mask))
    assert abs(float(tm["distill_loss"]) - float(jm["distill_loss"])) < TOL
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=TOL)
    _assert_trees_close(tnew["params"], jnew["params"], td.cfg)


def test_host_loops_match_reference():
    pair, toks = _pair(512)
    jd, jdstate, td, tdstate = pair["d"]
    jt, jtstate, tt, ttstate = pair["t"]
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 512, (2, 16)).astype(np.int32) for _ in range(2)]
    jstate, jhist = jpt.train(jd, jdstate, iter(batches), JTrainConfig(**TC), 2,
                              log_every=1)
    tstate, thist = tpt.train(td, tdstate, iter(batches), TrainConfig(**TC), 2,
                              log_every=1)
    _assert_trees_close(tstate["params"], jstate["params"], td.cfg)
    seen = []
    jstate, jhist2 = jfinetune(jd, jt, jstate, jtstate["params"],
                                  iter(batches), JTrainConfig(**TC), 2,
                                  log_every=2, use_pallas=True)
    tstate, thist2 = finetune(td, tt, tstate, ttstate["params"],
                                  iter(batches), TrainConfig(**TC), 2,
                                  log_every=2, use_kernels=True,
                                  callback=lambda i, m: seen.append(i))
    _assert_trees_close(tstate["params"], jstate["params"], td.cfg)
    assert seen == [2] and int(tstate["opt"]["step"]) == 4
    for th, jh in ((thist, jhist), (thist2, jhist2)):
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        for a, b in zip(th, jh):
            assert abs(a["loss"] - b["loss"]) < TOL


def test_train_state_keeps_float32_master_weights():
    cfg = reduced(get_config("llama2-7b-chat"))
    assert cfg.compute_dtype == torch.bfloat16
    model = TModel(cfg.drafter(), "cpu")
    state = tpt.make_train_state(model, 1, TrainConfig())
    for leaf in tree_leaves(state["params"]):
        assert leaf.dtype == torch.float32
    for leaf in tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"]):
        assert leaf.dtype == torch.float32 and not leaf.any()
    assert int(state["opt"]["step"]) == 0
    # serving keeps the compute dtype
    assert model.init(1)["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_greedy_distillation_data_matches_reference(models):
    jt, jtp = models["j"][:2]
    tt, ttp = models["t"][:2]
    seeds = np.random.default_rng(6).integers(
        3, jt.cfg.vocab_size, (3, 10)).astype(np.int32)
    kw = dict(temperatures=(0.0,), max_response_tokens=6, batch_size=2)
    want = jdatagen.generate_distillation_dataset(
        jt, jtp, seeds, jdatagen.DatagenConfig(**kw))
    got = tdatagen.generate_distillation_dataset(
        tt, ttp, seeds, tdatagen.DatagenConfig(**kw))
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_packing_and_mixing_match_reference():
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, 100, rng.integers(1, 30)) for _ in range(20)]
    chunks = tpack.pack_documents(docs, 16)
    np.testing.assert_array_equal(chunks, jpack.pack_documents(docs, 16))
    for a, b in zip(tpack.shift_labels(chunks), jpack.shift_labels(chunks)):
        np.testing.assert_array_equal(a, b)
    pre = rng.integers(1, 100, (5, 16)).astype(np.int32)
    for got, want in zip(tmix.mixed_batches(chunks, pre, 4, seed=3, steps=3),
                         jmix.mixed_batches(chunks, pre, 4, seed=3, steps=3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tmix.simple_batches(pre, 3, seed=1, steps=2),
                         jmix.simple_batches(pre, 3, seed=1, steps=2)):
        np.testing.assert_array_equal(got, want)

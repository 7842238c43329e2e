"""Multi-codebook models (MusicGen's K 4) in the port against ``repro``, on
the CPU in float32.

Both packages get the same weights (the reference's seeded init carried
over by ``bridge.params_from_jax``: its (K, V, d) embedding and (K, d, V)
head come across as they are) and the same seeded numpy ids of shape (B,
K, S). Logits, the CE and its gradients must agree within 2e-5 of their
scale (float32 on both sides; only the order of sums differs), and one
train step's parameters within 1e-5. Prefill plus decode must give the
full forward's logits within 1e-4 (the reference test's tolerance) and the
reference's decode logits within 2e-5 of scale.

The reference serves no multi-codebook model continuously and cannot
distill one (its (B, S) mask against (B, S, K, V) logits, ROADMAP §3 item
11): the port refuses both, the first with the reference's message, the
second naming the item, and the tests show the reference's failure beside
the refusal.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import Model as JModel
from repro.models import model as jmodel
from repro.quant import calib as jcalib
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.training import pretrain as jpt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import QuantConfig, TrainConfig
from repro_torch.launch import train
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, lm_head_logits
from repro_torch.models.model import Model as TModel
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.quant import calib as tcalib
from repro_torch.quant.qweight import QWeight
from repro_torch.serving import ContinuousEngine
from repro_torch.training import make_train_step
from repro_torch.training.finetune import finetune
from torch_parity import one_torch_thread, port_config, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# the module: ``repro.training.finetune`` is also the package's function
jfinetune = importlib.import_module("repro.training.finetune")

REL = 2e-5          # of the scale, float32 on both sides
STEP_TOL = 1e-5     # a train step's parameters (test_torch_training's)
K, B, S = 4, 2, 16
# the reference test's config (tests/test_serving_system.py), in float32
BASE = dict(arch_type="audio", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, attn_chunk=16,
            remat=False, num_codebooks=K, dtype="float32")
CONFIGS = {
    "untied": JConfig(name="mg", **BASE),
    "tied_softcap": JConfig(name="mg-tied", tie_embeddings=True,
                            final_softcap=30.0, **BASE),
}


@functools.lru_cache(maxsize=None)
def jitted(fn, *static):
    """The reference's ``fn`` jitted with the named arguments static, once
    per (fn, static)."""
    return jax.jit(fn, static_argnames=static)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference model, its params, port model, port params): the
    reference's seeded init on both sides."""
    jcfg = CONFIGS[name]
    jm = JModel(jcfg)
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tm = TModel(port_config(jcfg), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


def ids(shape, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_embedding_and_head_logits_match_the_reference(name):
    """The bridged (K, V, d) table and (K, d, V) head keep their shapes;
    the summed embeddings, the head's (B, S, K, V) logits (the tied table
    with its last two axes swapped, the softcap) and a full forward's
    logits equal the reference's."""
    jm, jp, tm, tp = pair(name)
    V, d = tm.cfg.vocab_size, tm.cfg.d_model
    assert tuple(tp["embed"].shape) == (K, V, d)
    if not tm.cfg.tie_embeddings:
        assert tuple(tp["lm_head"].shape) == (K, d, V)
    toks = ids((B, K, S))
    from repro.models import layers as jlayers
    from repro.models import transformer as jtfm
    close(embed_tokens(tp["embed"], tensor(toks, torch.long)),
          jlayers.embed_tokens(jp["embed"], jnp.asarray(toks)))
    h = np.random.default_rng(3).standard_normal((B, S, d)).astype(np.float32)
    logits = tfm.logits_from_hidden(tp, tensor(h), tm.cfg)
    assert logits.shape == (B, S, K, V) and logits.dtype == torch.float32
    close(logits, jtfm.logits_from_hidden(jp, jnp.asarray(h), jm.cfg))
    w = np.random.default_rng(4).standard_normal((K, d, V)).astype(np.float32)
    close(lm_head_logits(tensor(w), tensor(h), 5.0),
          jlayers.lm_head_logits(jnp.asarray(w), jnp.asarray(h), 5.0))
    close(tm.logits(tp, tensor(toks, torch.long)),
          jitted(jm.logits)(jp, jnp.asarray(toks))[0])


def test_ce_and_gradients_match_the_reference(monkeypatch):
    """``loss_ce`` over (B, K, S) labels with masked (-1) entries, in two
    loss chunks (each chunk's labels moved to (B, C, K)), and its gradient
    leaf by leaf."""
    monkeypatch.setattr(jmodel, "LOSS_CHUNK", 8)
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", 8)
    jm, jp, tm, tp = pair("untied")
    toks, labels = ids((B, K, S)), ids((B, K, S), seed=2)
    labels[0, 1, 3:9] = -1
    labels[1, :, -1] = -1

    def jloss(p):
        return jm.loss_ce(p, jnp.asarray(toks), jnp.asarray(labels))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    from repro_torch.training.pretrain import value_and_grad
    tl, tg = value_and_grad(
        lambda p: tm.loss_ce(p, tensor(toks, torch.long),
                             tensor(labels, torch.long))[0], tp)
    assert abs(float(tl) - float(jl)) <= REL * float(jl)
    want = params_from_jax(jax.tree.map(np.asarray, jg), tm.cfg, "cpu")
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(jg))
    got, exp = tree_leaves(tg), tree_leaves(want)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= REL * scale


def test_train_step_matches_the_reference():
    """One CE and AdamW step (``make_train_step``) at K 4: the loss and
    every parameter after it."""
    jm, jp, tm, tp = pair("untied")
    tc = dict(warmup_steps=1, total_steps=10, learning_rate=1e-4)
    toks, labels = ids((B, K, S)), ids((B, K, S), seed=2)
    jstate = {"params": jp,
              "opt": jax.jit(lambda p: jpt.init_opt_state(p, jnp.float32))(jp)}
    jnew, jm_ = jax.jit(jpt.make_train_step(jm, JTrainConfig(**tc)))(
        jstate, jnp.asarray(toks), jnp.asarray(labels))
    tnew, tm_ = make_train_step(tm, TrainConfig(**tc))(
        {"params": tp, "opt": init_opt_state(tp)}, tensor(toks, torch.long),
        tensor(labels, torch.long))
    assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= REL * float(jm_["loss"])
    assert np.isfinite(float(tm_["grad_norm"]))
    want = params_from_jax(jax.tree.map(np.asarray, jnew["params"]), tm.cfg,
                           "cpu")
    for a, b in zip(tree_leaves(tnew["params"]), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_TOL, rtol=0)


def test_multicodebook_decode_consistency():
    """The port of ``test_serving_system.py::test_multicodebook_decode_
    consistency``: prefill of (B, K, 16), then a decode step of K ids at
    position 16, equals the full forward at that position, and the
    reference's decode logits."""
    jm, jp, tm, tp = pair("untied")
    toks = ids((B, K, 16))
    _, cache = tm.prefill(tp, tensor(toks, torch.long), cache_len=20)
    nxt = toks[:, :, :1]
    pos = torch.full((B, 1), 16, dtype=torch.int32)
    lg, _ = tm.decode_step(tp, tensor(nxt, torch.long), pos, cache)
    full = np.concatenate([toks, nxt], axis=-1)
    lg_full = tm.logits(tp, tensor(full, torch.long))
    assert lg.shape == (B, 1, K, 64)
    assert torch.allclose(lg[:, 0], lg_full[:, 16], atol=1e-4)
    _, jcache = jitted(jm.prefill, "cache_len")(jp, jnp.asarray(toks),
                                                cache_len=20)
    jlg, _ = jitted(jm.decode_step)(jp, jnp.asarray(nxt),
                                    jnp.full((B, 1), 16, jnp.int32), jcache)
    close(lg, jlg)


def test_quantized_leaves_at_k4_are_the_references():
    """int8 weights at K 4: the same leaves are quantized as in the
    reference (every 2-D projection) and the (K, V, d) table and (K, d, V)
    head stay unquantized; the quantized logits agree within 2e-5 of
    scale."""
    jm, jp, tm, tp = pair("untied")
    jq = jcalib.quantize_params(jm, jp, JQuantConfig(weights="int8"))
    tq = tcalib.quantize_params(tm, tp, QuantConfig(weights="int8"))
    want = params_from_jax(jax.tree.map(np.asarray, jq), tm.cfg, "cpu")

    def kinds(tree):
        return [type(x).__name__ for x in _leaves(tree)]

    assert kinds(tq) == kinds(want)
    assert not isinstance(tq["embed"], QWeight)
    assert not isinstance(tq["lm_head"], QWeight)
    assert sum(isinstance(x, QWeight) for x in _leaves(tq)) == 7 * 2
    toks = ids((B, K, S))
    close(tm.logits(tq, tensor(toks, torch.long)),
          jitted(jm.logits)(jq, jnp.asarray(toks))[0])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_continuous_engine_refuses_multi_codebook():
    """A K 4 target or drafter is refused at construction, with the
    reference engine's message."""
    jm, jp, tm, tp = pair("untied")
    single = TModel(tm.cfg.replace(name="k1", num_codebooks=1), device="cpu")
    jsingle = JModel(jm.cfg.replace(name="k1", num_codebooks=1))
    for target, draft, jt, jd in ((tm, single, jm, jsingle),
                                  (single, tm, jsingle, jm)):
        with pytest.raises(ValueError, match="multi-codebook decode is not "
                           "supported"):
            JEngine(target=jt, target_params=None, draft=jd)
        with pytest.raises(ValueError, match="multi-codebook decode is not "
                           "supported"):
            ContinuousEngine(target=target, target_params=None, draft=draft)


def test_distillation_is_refused_where_the_reference_fails():
    """The reference's distillation at K 4 fails on its (B, S) mask against
    (B, S, K, V) logits; the port's ``finetune`` refuses the models first,
    naming ROADMAP §3 item 11."""
    jm, jp, tm, tp = pair("untied")
    toks = ids((B, K, S))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jfinetune.finetune(jm, jm, {"params": jp, "opt": jpt.init_opt_state(
            jp, jnp.float32)}, jp, iter([toks]), JTrainConfig(), 1)
    with pytest.raises(ValueError, match=r"ROADMAP §3 item 11"):
        finetune(tm, tm, {"params": tp, "opt": init_opt_state(tp)}, tp,
                 iter([toks]), TrainConfig(), 1)


def test_training_cli_at_k4(capsys, one_torch_thread):
    """``launch.train --arch musicgen-large --reduced``: pretraining on the
    stream replicated per codebook runs with finite losses; ``--phase
    distill`` exits naming ROADMAP §3 item 11 and ``--draft-head`` with the
    reference's message, before anything is built."""
    train.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    losses = [float(line.split("'loss': ")[1].split(",")[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                    "--phase", "distill"])
    assert "ROADMAP §3 item 11" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                    "--draft-head", "eagle"])
    assert exc.value.code == "--draft-head supports single-codebook targets"


"""The paper's pipeline in the port against the reference: the synthetic
corpus draw for draw, subcloning leaf by leaf, the pipeline's configs and
result record, a micro run of ``run_pipeline`` on the CPU, its pretraining
phase from the reference's own initial weights, and the training CLI.

The port's pipeline computes with torch on the CPU here; its models are
tiny, so the module runs torch on one thread (many threads only add
overhead at these sizes)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.experiments.pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import Model as JModel
from repro.models.subclone import subclone as jsubclone
import repro_torch.experiments.pipeline as tpipe
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint.io import load
from repro_torch.configs.base import TrainConfig
from repro_torch.core.losses import kld
from repro_torch.data import (OOD_TASKS, TASKS, SyntheticCorpus,
                              pack_documents, simple_batches)
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import Model as TModel
from repro_torch.models.subclone import subclone
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.training import make_train_state, train
from torch_parity import port_config

# pretraining CE after the same steps from the same float32 weights on the
# same batches: both sides differ only in the order of their sums, which
# the early AdamW steps (lr 3e-3) amplify in weights whose gradient is
# near 0 (1.4e-6 apart on this test's inputs)
CE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,seed,conc", [(64, 0, 0.25), (128, 3, 0.08)])
def test_corpus_matches_reference_draw_for_draw(vocab, seed, conc):
    ref = jsyn.SyntheticCorpus(vocab_size=vocab, seed=seed, concentration=conc)
    port = SyntheticCorpus(vocab_size=vocab, seed=seed, concentration=conc)
    assert (TASKS, OOD_TASKS) == (jsyn.TASKS, jsyn.OOD_TASKS)
    for task, t in ref._trans.items():
        assert np.array_equal(port._trans[task], t), task
    for a, b in zip(port.pretrain_docs(30, 40), ref.pretrain_docs(30, 40)):
        assert np.array_equal(a, b)
    for task in TASKS:
        for a, b in zip(port.chat_sft_docs(4, task), ref.chat_sft_docs(4, task)):
            assert np.array_equal(a, b)
    for task in TASKS + OOD_TASKS:
        assert np.array_equal(port.instructions(3, 12, task),
                              ref.instructions(3, 12, task))


T_CFG = jpipe.target_config().replace(name="t", num_layers=4, d_model=96,
                                      num_heads=4, head_dim=24, d_ff=192,
                                      vocab_size=96, dtype="float32")
D_CFG = T_CFG.replace(name="d", num_layers=2, d_model=48, head_dim=12, d_ff=96)


def test_subclone_equals_reference_leaf_by_leaf():
    jt, jd = JModel(T_CFG), JModel(D_CFG)
    jtp, _ = jt.init(jax.random.PRNGKey(0))
    jdp, _ = jd.init(jax.random.PRNGKey(1))
    want = jsubclone(jtp, T_CFG, jdp, D_CFG)

    def bridge(tree, cfg):
        return params_from_jax(jax.tree.map(np.asarray, tree), port_config(cfg),
                               "cpu", dtype=torch.float32)

    got = subclone(bridge(jtp, T_CFG), port_config(T_CFG), bridge(jdp, D_CFG),
                   port_config(D_CFG))
    exp = bridge(want, D_CFG)
    assert len(tree_leaves(got)) == len(tree_leaves(exp))
    for a, b in zip(tree_leaves(got), tree_leaves(exp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_subclone_starts_closer_to_a_trained_target_than_random():
    """The mirror of the reference's test_subclone.py."""
    tcfg, dcfg = port_config(T_CFG), port_config(D_CFG)
    target, draft = TModel(tcfg, "cpu"), TModel(dcfg, "cpu")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                     batch_size=8, seq_len=32)
    corpus = SyntheticCorpus(vocab_size=96, seed=0, concentration=0.1)
    chunks = pack_documents(corpus.pretrain_docs(150, 64), 32)
    tstate = make_train_state(target, 0, tc)
    tstate, _ = train(target, tstate, simple_batches(chunks, 8), tc, 60)
    d_rand = make_train_state(draft, 1, tc)["params"]
    d_sub = subclone(tstate["params"], tcfg, d_rand, dcfg)
    for a, b in zip(tree_leaves(d_rand), tree_leaves(d_sub)):
        assert a.shape == b.shape and a.dtype == b.dtype

    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 96, (4, 32)))
    with torch.no_grad():
        t_logits = target.logits(tstate["params"], toks)

        def div(dp):
            return float(kld(draft.logits(dp, toks), t_logits, torch.ones(4, 32)))

        assert np.isfinite(div(d_sub))
        assert div(d_sub) < div(d_rand), (div(d_sub), div(d_rand))


@pytest.mark.parametrize("which", ["target_config", "draft_config"])
def test_configs_and_param_counts_match_reference(which):
    jcfg, tcfg = getattr(jpipe, which)(), getattr(tpipe, which)()
    assert tcfg == port_config(jcfg)
    jp, _ = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = TModel(tcfg, "cpu").init(0)
    assert tpipe.count_params(tp) == jpipe.count_params(jp) == tcfg.param_count()


def test_result_record_and_decoding_match_reference():
    names = [f.name for f in dataclasses.fields(tpipe.ReproResult)]
    assert names == [f.name for f in dataclasses.fields(jpipe.ReproResult)]
    assert tpipe.TASK_DECODING == jpipe.TASK_DECODING
    assert (tpipe.VOCAB, tpipe.SEQ) == (jpipe.VOCAB, jpipe.SEQ)


def test_micro_pipeline_runs_on_the_cpu():
    """The sizes and checks of the reference's test_end_to_end_micro_pipeline."""
    res = tpipe.run_pipeline(pretrain_steps=20, draft_pretrain_steps=14,
                             finetune_steps=8, ckpt_every=4, n_seeds_per_task=2,
                             eval_prompts=2, eval_new_tokens=10, sft_steps=6,
                             losses=("tvdpp",), gammas=(3,), batch=8,
                             verbose=False, device="cpu")
    assert res.c_ratio < 0.2
    assert "tvdpp" in res.tau
    for task in ("dolly", "cnndm", "xsum"):
        assert 1.0 <= res.tau["tvdpp"][task]["3"] <= 4.0
    assert res.ood["base"] >= 1.0
    assert set(res.tau) == set(res.mbsu) == set(res.ood) == {"base", "tvdpp"}
    assert [s for s, _ in res.tau_by_ckpt["tvdpp"]["dolly"]] == [4, 8]
    assert set(res.token_rate_ratio) == {"3"} and res.token_rate_ratio["3"] > 0


def test_pretrain_ce_matches_reference_from_the_same_weights(monkeypatch):
    """Both pipelines in float32, the port's models starting from the
    reference's initial parameters (bridged): the pretraining CE of target
    and drafter agree within CE_TOL, and so does c."""
    cfgs = {}
    for which in ("target_config", "draft_config"):
        jcfg = getattr(jpipe, which)().replace(dtype="float32")
        cfgs[jcfg.name] = jcfg
        monkeypatch.setattr(jpipe, which, lambda c=jcfg: c)
        monkeypatch.setattr(tpipe, which, lambda c=jcfg: port_config(c))

    def ref_init_state(model, seed, tc):
        jp, _ = JModel(cfgs[model.cfg.name]).init(jax.random.PRNGKey(seed))
        params = params_from_jax(jax.tree.map(np.asarray, jp), model.cfg,
                                 model.device, dtype=torch.float32)
        return {"params": params, "opt": init_opt_state(params)}

    monkeypatch.setattr(tpipe, "make_train_state", ref_init_state)
    kw = dict(pretrain_steps=4, draft_pretrain_steps=4, finetune_steps=1,
              ckpt_every=1, n_seeds_per_task=1, eval_prompts=1,
              eval_new_tokens=2, sft_steps=1, losses=(), gammas=(3,), batch=4,
              verbose=False)
    want = jpipe.run_pipeline(**kw)
    got = tpipe.run_pipeline(device="cpu", **kw)
    assert got.c_ratio == want.c_ratio
    for name in ("target", "draft"):
        assert abs(got.pretrain_ce[name] - want.pretrain_ce[name]) <= CE_TOL, \
            (got.pretrain_ce, want.pretrain_ce)


@pytest.mark.parametrize("phase", ["pretrain", "distill"])
def test_train_cli_on_the_cpu(phase, tmp_path, capsys):
    out = tmp_path / "params.npz"
    tlaunch.main(["--arch", "llama2-7b-chat", "--reduced", "--device", "cpu",
                  "--phase", phase, "--steps", "4", "--batch", "2", "--seq",
                  "32", "--save", str(out)])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 4 and all("'loss': nan" not in ln for ln in steps)
    assert lines[-1] == f"saved params -> {out}"
    cfg = tlaunch.reduced(tlaunch.get_config("llama2-7b-chat"))
    if phase == "distill":
        cfg = cfg.replace(num_layers=1)
    like = TModel(cfg, "cpu").init(0, dtype=torch.float32)
    assert len(tree_leaves(load(str(out), like))) == len(tree_leaves(like))


def test_train_cli_refuses_the_full_vocabulary_corpus():
    with pytest.raises(SystemExit, match="pass --reduced"):
        tlaunch.main(["--arch", "llama2-7b-chat", "--device", "cpu"])

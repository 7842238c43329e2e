"""The port's head distillation (``repro_torch.draftheads.train``) against
the reference's, and the head flags of the port's training and serving
CLIs, at the reference test's tiny size (D 64, 4 heads, 2 KV heads, V 64,
a 4-layer float32 target; the CLIs at the reduced Llama-2 config).

One distillation step of each head kind from the same parameters and batch
must give the reference's loss terms within 1e-5 and its updated
parameters within 1e-4 relative (float32 on both sides)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.draftheads import drafter as jdrafter
from repro.draftheads import heads as jheads
from repro.draftheads import train as jtrain
from repro_torch.bridge import head_params_from_jax
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.draftheads import (HeadConfig, HeadDrafter, finetune_heads,
                                    make_head_distill_step, make_head_train_state)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import init_opt_state
from test_torch_draftheads import JCFG, V, flat, randomised, target  # noqa: F401
from torch_parity import TOL, one_torch_thread, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
STEP_RTOL = 1e-4


@pytest.mark.parametrize("kind,loss", [("eagle", "tvdpp"), ("medusa", "tvdpp"),
                                       ("eagle", "kld")])
def test_head_distill_step_matches_reference(target, kind, loss):
    jt, jtp, tt, ttp = target
    jh = jdrafter.HeadDrafter(jheads.HeadConfig.for_target(kind, JCFG))
    np_hp = randomised(jax.tree.map(np.asarray, jh.init(jax.random.PRNGKey(3))),
                       np.random.default_rng(20))
    th = HeadDrafter(HeadConfig(**dataclasses.asdict(jh.hc)))
    thp = head_params_from_jax(np_hp, th.hc, "cpu")
    jhp = jax.tree.map(jnp.asarray, np_hp)
    rng = np.random.default_rng(21)
    tokens = rng.integers(3, V, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 7:] = 0.0                                    # a padded tail
    jstate = {"params": jhp, "opt": jtrain.init_opt_state(jhp)}
    jnew, jm = jtrain.make_head_distill_step(jh, jt, JTrainConfig(**TC), loss)(
        jstate, jtp, jnp.asarray(tokens), jnp.asarray(mask))
    tstate = {"params": thp, "opt": init_opt_state(thp)}
    tnew, tm = make_head_distill_step(th, tt, TTrainConfig(**TC), loss)(
        tstate, ttp, tensor(tokens, torch.long), tensor(mask))
    for name in ("loss", "distill_loss", "feat_l2", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   atol=TOL, rtol=0, err_msg=name)
    if kind == "eagle":
        assert float(tm["feat_l2"]) > 0
    want = flat(jax.tree.map(np.asarray, jnew["params"]))
    got = flat(tnew["params"])
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= STEP_RTOL, (path, err)
        assert not np.array_equal(g, np_hp_leaf(np_hp, path)), path  # moved


def np_hp_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_finetune_heads_trains_only_the_heads(target):
    """The host loop over batches logs finite losses, moves every head
    parameter, leaves the target untouched, and keeps float32 masters."""
    _, _, tt, ttp = target
    chunks = np.random.default_rng(0).integers(3, V, (12, 16)).astype(np.int32)
    t_before = {k: v.clone() for k, v in flat(ttp_dict(ttp)).items()}
    for kind in ("eagle", "medusa"):
        drafter = HeadDrafter(HeadConfig.for_target(kind, tt.cfg))
        state = make_head_train_state(drafter, 7, "cpu")
        before = {k: v.clone() for k, v in flat(state["params"]).items()}
        batches = (chunks[4 * s:4 * (s + 1)] for s in range(3))
        state, hist = finetune_heads(drafter, tt, state, ttp, batches,
                                     TTrainConfig(**TC), 3, log_every=1)
        assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
        for path, leaf in flat(state["params"]).items():
            assert leaf.dtype == torch.float32
            assert not torch.equal(leaf, before[path]), (kind, path)
    for path, leaf in flat(ttp_dict(ttp)).items():
        assert torch.equal(leaf, t_before[path]), path


def ttp_dict(params):
    """The target's parameters with its layer list as a dict."""
    return {k: (dict(enumerate(v)) if isinstance(v, list) else v)
            for k, v in params.items()}


def test_head_clis_train_save_and_serve(tmp_path, capsys):
    """``launch.train --draft-head`` saves a checkpoint that ``launch.serve
    --draft-head --head-ckpt`` serves by tree, static and continuous; a
    Medusa chain serves without one; the refused combinations exit."""
    ckpt = str(tmp_path / "eagle.npz")
    base = ["--arch", "llama2-7b-chat", "--reduced", "--device", "cpu"]
    ttrain.main(base + ["--draft-head", "eagle", "--steps", "3", "--batch", "4",
                        "--seq", "16", "--datagen-seqs", "2", "--save", ckpt])
    out = capsys.readouterr().out
    assert "saved eagle head params" in out and out.count("step ") == 3
    tserve.main(base + ["--draft-head", "eagle", "--head-ckpt", ckpt, "--tree",
                        "--temperature", "0.7", "--requests", "2",
                        "--max-new", "8"])
    out = capsys.readouterr().out
    assert "draft=eagle-head" in out and "tree SD: tau=" in out
    tserve.main(base + ["--draft-head", "eagle", "--head-ckpt", ckpt,
                        "--continuous", "--tree", "--prefix-cache",
                        "--traffic-mix", "chat", "--requests", "3",
                        "--temperature", "0.7"])
    assert "continuous: 3 requests" in capsys.readouterr().out
    tserve.main(base + ["--draft-head", "medusa", "--requests", "2",
                        "--max-new", "8", "--temperature", "0.7"])
    assert "served 2 requests" in capsys.readouterr().out
    for bad in (["--draft-head", "eagle", "--no-draft"],
                ["--draft-head", "eagle", "--quant-weights", "int8"],
                ["--head-ckpt", ckpt]):
        with pytest.raises(SystemExit):
            tserve.main(base + bad)

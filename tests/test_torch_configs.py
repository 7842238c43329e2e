"""The port's architecture registry against ``repro.configs``.

The configs are plain data: every field, ``param_count``, ``drafter()`` and
``reduced()`` must equal the reference's exactly (no tolerance). Every
config constructs: MusicGen with its four codebooks too, at full width on
the meta device (shapes only) and reduced on the CPU, and the training CLI
pretrains it; ``check_config`` refuses nothing in the registry. The
serving CLI serves MusicGen's single-codebook variant, as the reference's
launcher does, and the training CLI refuses its distillation (ROADMAP §3
item 11) with a message, not a traceback."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as jcfgs
from repro.configs import base as jbase
import repro_torch.configs as tcfgs
from repro_torch.configs import base as tbase
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ALL = list(jcfgs.ARCHS)
SERVED = ("phi4-mini-3.8b", "minitron-4b", "chameleon-34b", "yi-9b",
          "gemma2-9b", "granite-moe-3b-a800m", "grok-1-314b", "llama2-7b-chat",
          "llama2-chat-drafter-115m", "zamba2-7b", "xlstm-1.3b",
          "musicgen-large")


def as_dict(cfg):
    """Every field, plus the compute dtype by name."""
    d = dataclasses.asdict(cfg)
    d["compute_dtype"] = str(cfg.compute_dtype).split(".")[-1]
    return d


def test_registry_keys_and_assigned_equal_the_reference():
    assert list(tcfgs.ARCHS) == ALL
    assert tcfgs.ASSIGNED == jcfgs.ASSIGNED
    assert [f.name for f in dataclasses.fields(tbase.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ModelConfig)]
    for kind in ("ATTN", "LOCAL_ATTN", "MAMBA", "MLSTM", "SLSTM", "SHARED_ATTN"):
        assert getattr(tbase, kind) == getattr(jbase, kind)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ALL)
def test_config_param_count_drafter_reduced_equal_the_reference(arch):
    t, j = tcfgs.get_config(arch), jcfgs.get_config(arch)
    assert as_dict(t) == as_dict(j)
    assert t.is_moe == j.is_moe
    assert t.param_count() == j.param_count()
    assert as_dict(t.drafter()) == as_dict(j.drafter())
    assert t.drafter().param_count() == j.drafter().param_count()
    for vocab in (512, 64):
        tr, jr = tcfgs.reduced(t, vocab), jcfgs.reduced(j, vocab)
        assert as_dict(tr) == as_dict(jr)
        assert tr.param_count() == jr.param_count()
        assert as_dict(tr.drafter()) == as_dict(jr.drafter())


@pytest.mark.parametrize("arch", jcfgs.ASSIGNED)
def test_full_config_metadata(arch):
    """The port of ``test_configs_smoke.py::test_full_config_metadata``."""
    cfg = tcfgs.get_config(arch)
    assert cfg.citation
    assert cfg.num_heads % cfg.num_kv_heads == 0
    assert cfg.param_count() > 1e8
    d = cfg.drafter()
    assert d.param_count() < 0.12 * cfg.param_count(), \
        f"drafter too large: {d.param_count() / cfg.param_count():.2%}"


def test_paper_pair_sizes():
    """The port of ``test_configs_smoke.py::test_paper_pair_sizes``: the
    drafter is about 1.64% of Llama 2 7B (paper Table 1)."""
    t = tcfgs.get_config("llama2-7b-chat")
    d = tcfgs.get_config("llama2-chat-drafter-115m")
    ratio = d.param_count() / t.param_count()
    assert 0.01 < ratio < 0.025, ratio
    assert abs(t.param_count() - 6.7e9) / 6.7e9 < 0.1
    assert abs(d.param_count() - 115e6) / 115e6 < 0.25
    assert t.arch_type == "dense" and "Table 1" in t.citation


@pytest.mark.parametrize("arch", SERVED)
def test_served_configs_pass_the_check(arch):
    cfg = tcfgs.get_config(arch)
    for cfg in (cfg, cfg.drafter(), tcfgs.reduced(cfg)):
        tfm.check_config(cfg)


@pytest.mark.parametrize("size", ("full", "reduced"))
def test_musicgen_k4_constructs(size):
    """MusicGen with its four codebooks: a (K, V, d) embedding and a (K, d,
    V) head beside the per-layer blocks, and caches; at full width on the
    meta device (3.25B parameters: shapes and dtypes, nothing drawn),
    reduced on the CPU with the paged pool too."""
    cfg = tcfgs.get_config("musicgen-large")
    device = "meta"
    if size == "reduced":
        cfg, device = tcfgs.reduced(cfg), "cpu"
    model = Model(cfg, device=device)
    params = model.init(0)
    K, V, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    assert K == 4
    assert tuple(params["embed"].shape) == (K, V, d)
    assert tuple(params["lm_head"].shape) == (K, d, V)
    assert params["embed"].device.type == device
    assert sum(x.numel() for x in _leaves(params)) == cfg.param_count()
    assert len(params["layers"]) == cfg.num_layers
    cache = model.init_cache(2, 16)
    assert len(cache) == cfg.num_layers
    assert tuple(cache[0]["k"].shape) == (2, 16, cfg.num_kv_heads, cfg.head_dim_)
    if size == "reduced":
        assert len(model.init_paged_cache(4, 16)) == cfg.num_layers


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_refusal_names_each_feature():
    """Nothing in the registry is refused: softcaps and qk-norm, scaled
    embeddings and local_attn layers, experts, the recurrent kinds and
    zamba2's shared attention construct, with a parameter dict and a cache
    per layer (empty for a shared_attn layer, whose set sits in
    ``params["shared_attn"]``), and the recurrent ones refuse the paged
    pool with the reference's message; a layer kind the port does not
    know is refused by name."""
    refused = []
    for arch in ALL:
        try:
            tfm.check_config(tcfgs.get_config(arch))
        except ValueError:
            refused.append(arch)
    assert refused == []
    base = tcfgs.reduced(tcfgs.get_config("yi-9b"))
    with pytest.raises(ValueError, match="the 'conv' layer kind is not ported"):
        Model(base.replace(layer_pattern=("conv",)), device="cpu").init(0)
    Model(base.replace(attn_softcap=50.0, final_softcap=30.0, qk_norm=True),
          device="cpu").init(0)
    for over in (dict(scale_embed=True),
                 dict(layer_pattern=("local_attn", "attn")),
                 dict(num_experts=4, num_experts_per_tok=2),
                 dict(layer_pattern=("mamba",), ssm_state_dim=16),
                 dict(layer_pattern=("mamba", "mamba", "shared_attn"),
                      ssm_state_dim=16, shared_attn_period=2),
                 dict(layer_pattern=("mlstm", "slstm"), d_ff=0)):
        model = Model(base.replace(**over), device="cpu")
        params = model.init(0)
        kinds = tfm.layer_kinds(model.cfg)
        assert len(params["layers"]) == base.num_layers
        assert len(model.init_cache(2, 16)) == base.num_layers
        assert ("moe" in params["layers"][0]) == ("num_experts" in over)
        assert [lp == {} for lp in params["layers"]] == \
            [k == "shared_attn" for k in kinds]
        assert ("shared_attn" in params) == ("shared_attn" in kinds)
        if set(kinds) <= {"attn", "local_attn", "shared_attn"}:
            assert len(model.init_paged_cache(4, 16)) == base.num_layers
        else:
            with pytest.raises(ValueError, match="paged KV cache requires an "
                               "attention-only pattern; got m"):
                model.init_paged_cache(4, 16)


def test_train_cli_pretrains_musicgen_k4(capsys, one_torch_thread):
    """The training CLI pretrains MusicGen with its four codebooks on the
    stream replicated per codebook (the serving CLI serves its
    single-codebook variant: ``test_serve_cli_serves_musicgen_single_
    codebook``)."""
    train.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "done in" in out, out
    assert "nan" not in out, out


def test_train_cli_k4_refusal_is_no_traceback():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-large", "--reduced", "--device", "cpu", "--phase",
         "distill"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 1, proc
    assert "Traceback" not in proc.stderr, proc.stderr
    assert "ROADMAP §3 item 11" in proc.stderr, proc.stderr


def test_serve_cli_serves_musicgen_single_codebook(capsys, one_torch_thread):
    """As the reference's launcher: the note, then a served run of the
    single-codebook variant (MHA, head dim 32 reduced) by tree."""
    serve.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                "--tree", "--temperature", "0.7", "--requests", "2",
                "--prompt-len", "8", "--max-new", "8"])
    out = capsys.readouterr().out
    assert "note: serving single-codebook variant of musicgen-large-reduced" in out
    assert "arch=musicgen-large-reduced draft=musicgen-large-reduced-drafter" in out
    assert "tree SD: tau=" in out and "kernel launches:" in out
    # the launcher's own config: K 1, everything else the arch's
    cfg = serve.serving_config("musicgen-large", True)
    assert cfg.num_codebooks == 1
    assert cfg == tcfgs.reduced(tcfgs.get_config("musicgen-large")).replace(
        num_codebooks=1)

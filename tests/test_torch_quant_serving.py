"""The port's quantized serving path against the reference: quantized
prefill and decode logits, int8-KV decode, temperature-0 chain and tree
tokens with a quantized drafter and target, and the serve CLI.

Both packages serve the reduced Llama-2 pair in float32 with the same
quantized weights: the reference's ``quantize_params`` (AWQ-lite, calibrated
on the same tokens) carried over by the bridge. On the reference side every
matmul runs its Pallas ``quant_matmul`` in interpret mode; on the port's,
the plain version of the CUDA kernel. Tolerances: logits within 1e-5 of
their scale, float32 sums in another order. In an int8 cache an entry whose
K or V value lies within rounding of a half step may round to the
neighbouring integer on one side, so int8 entries may differ by one step,
and the int8-KV logits get 1e-3 of their scale on top. Tokens at
temperature 0 must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs import llama2_7b_chat as jllama
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import speculative as jspec
from repro.models import attention as jattn
from repro.models import Model as JModel
from repro.quant import calib as jcalib
from repro.quant import kvcache as jkv
from repro.spectree import round as jround
from repro.spectree import tree as jtree
from repro_torch.bridge import params_from_jax
from repro_torch.core import speculative as tspec
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import Model as TModel
from repro_torch.quant import QWeight, kvcache as tkv
from repro_torch.spectree import round as tround
from repro_torch.spectree import tree as ttree
from torch_parity import port_config, tensor

REL = 1e-5
KV_REL = 1e-3
B, S, MAX_NEW = 2, 12, 12
QUANTS = {"int8": JQuantConfig(weights="int8"),
          "int4": JQuantConfig(weights="int4", group_size=32)}


@pytest.fixture(scope="module", params=sorted(QUANTS))
def qmodels(request):
    """Reference and port (target, drafter), both quantized with the same
    AWQ-calibrated weights: {"j": [jt, jtp, jd, jdp], "t": [...]}."""
    out = {"j": [], "t": []}
    cfgs = (jcfgs.reduced(jllama.CONFIG), jcfgs.reduced(jllama.DRAFTER))
    calib = np.random.default_rng(5).integers(
        3, cfgs[0].vocab_size, (8, 16)).astype(np.int32)
    for cfg, seed in zip(cfgs, (0, 1)):
        jm = JModel(cfg.replace(dtype="float32"))
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        jq = jcalib.quantize_params(jm, jp, QUANTS[request.param],
                                    calib_tokens=calib)
        tm = TModel(port_config(jm.cfg), device="cpu")
        tq = params_from_jax(jax.tree.map(np.asarray, jq), tm.cfg, "cpu")
        assert isinstance(tq["layers"][0]["mlp"]["w_up"], QWeight)
        out["j"] += [jm, jq]
        out["t"] += [tm, tq]
    out["prompt"] = np.random.default_rng(3).integers(
        3, cfgs[0].vocab_size, (B, S)).astype(np.int32)
    return out


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def test_quantized_prefill_and_decode_logits(qmodels):
    prompt = qmodels["prompt"]
    for (jm, jp), (tm, tp) in zip(
            [qmodels["j"][:2], qmodels["j"][2:]],
            [qmodels["t"][:2], qmodels["t"][2:]]):
        jl, jc = jm.prefill(jp, jnp.asarray(prompt), cache_len=24)
        tl, tc = tm.prefill(tp, tensor(prompt, torch.long), cache_len=24)
        close(tl.numpy(), jl, REL)
        toks = np.random.default_rng(8).integers(
            3, jm.cfg.vocab_size, (B, 4)).astype(np.int32)
        pos = (S + np.arange(4))[None].repeat(B, 0).astype(np.int32)
        jl2, _ = jm.decode_step(jp, jnp.asarray(toks), jnp.asarray(pos), jc)
        tl2, _ = tm.decode_step(tp, tensor(toks, torch.long),
                                tensor(pos, torch.long), tc)
        close(tl2.numpy(), jl2, REL)
    assert all(n == 0 for n in ops.LAUNCHES.values())    # CPU: plain version


def test_init_cache_kv_quant_matches_reference(qmodels):
    jm, _, _, _ = qmodels["j"]
    tm, _, _, _ = qmodels["t"]
    jc = jm.init_cache(3, 40, kv_quant=True)["groups"][0]
    tc = tm.init_cache(3, 40, kv_quant=True)
    assert len(tc) == jm.cfg.num_layers
    for i, layer in enumerate(tc):
        assert set(layer) == set(jc)
        for name, t in layer.items():
            want = np.asarray(jc[name][i])
            assert t.shape == want.shape and str(t.dtype)[6:] == str(want.dtype)
            assert np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("tree", [False, True], ids=["chain", "tree-mask"])
def test_int8_kv_decode_logits(qmodels, tree, monkeypatch):
    """Prefill, convert the caches to int8, decode 4 tokens (a chain step, or
    tree nodes at storage slots under an ancestor mask)."""
    monkeypatch.setattr(jattn, "TREE_FASTPATH", True)
    jm, jp, _, _ = qmodels["j"]
    tm, tp, _, _ = qmodels["t"]
    prompt = qmodels["prompt"]
    _, jc = jm.prefill(jp, jnp.asarray(prompt), cache_len=24)
    _, tc = tm.prefill(tp, tensor(prompt, torch.long), cache_len=24)
    jc, tc = jkv.quantize_kv_cache(jc), tkv.quantize_kv_cache(tc)
    toks = np.random.default_rng(9).integers(
        3, jm.cfg.vocab_size, (B, 4)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if tree:
        pos = S + np.array([[0, 1, 1, 2]] * B, np.int32)
        slots = S + np.broadcast_to(np.arange(4, dtype=np.int32), (B, 4))
        amask = np.ones((B, 4, 24), bool)
        amask[:, :, S:S + 4] = np.array([[1, 0, 0, 0], [1, 1, 0, 0],
                                         [1, 0, 1, 0], [1, 1, 0, 1]], bool)
        kw_j = {"slots": jnp.asarray(slots), "attn_mask": jnp.asarray(amask)}
        kw_t = {"slots": tensor(slots, torch.long), "attn_mask": tensor(amask)}
    else:
        pos = (S + np.arange(4))[None].repeat(B, 0).astype(np.int32)
    jl, jc2 = jm.decode_step(jp, jnp.asarray(toks), jnp.asarray(pos), jc, **kw_j)
    tl, tc2 = tm.decode_step(tp, tensor(toks, torch.long), tensor(pos, torch.long),
                             tc, **kw_t)
    close(tl.numpy(), jl, REL + KV_REL)
    for i, layer in enumerate(tc2):
        jl_c = {n: np.asarray(jc2["groups"][0][n][i])
                for n in ("k", "v", "pos", "k_scale", "v_scale")}
        assert layer["k"].dtype == torch.int8 and layer["k_scale"].dtype == torch.float32
        assert np.array_equal(layer["pos"].numpy(), jl_c["pos"])
        for n in ("k", "v"):
            diff = np.abs(layer[n].numpy().astype(np.int32) - jl_c[n].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, n
            close(layer[n + "_scale"].numpy(), jl_c[n + "_scale"], REL)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv-fp", "kv-int8"])
def test_temp0_chain_and_tree_tokens_identical(qmodels, kv_quant, monkeypatch):
    monkeypatch.setattr(jattn, "TREE_FASTPATH", True)
    jt, jtp, jd, jdp = qmodels["j"]
    tt, ttp, td, tdp = qmodels["t"]
    prompt = qmodels["prompt"]
    jsdc = jspec.SDConfig(gamma=3, temperature=0.0, kv_quant=kv_quant)
    tsdc = tspec.SDConfig(gamma=3, temperature=0.0, kv_quant=kv_quant)
    jtok, jstats = jspec.speculative_generate(jd, jt, jdp, jtp,
                                              jnp.asarray(prompt), MAX_NEW, jsdc)
    ttok, tstats = tspec.speculative_generate(td, tt, tdp, ttp,
                                              tensor(prompt, torch.long),
                                              MAX_NEW, tsdc)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.tau == jstats.tau
    jtok, jstats = jround.tree_speculative_generate(
        jd, jt, jdp, jtp, jnp.asarray(prompt), MAX_NEW, jsdc,
        jtree.TreeSpec((2, 2)))
    ttok, tstats = tround.tree_speculative_generate(
        td, tt, tdp, ttp, tensor(prompt, torch.long), MAX_NEW, tsdc,
        ttree.TreeSpec((2, 2)))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.depth_acceptance() == jstats.depth_acceptance()


@pytest.mark.parametrize("tree", [False, True], ids=["chain", "tree"])
def test_serve_cli_quantized_on_cpu(tree, capsys):
    argv = ["--arch", "llama2-7b-chat", "--reduced", "--device", "cpu",
            "--quant-weights", "int4", "--quant-target", "--quant-kv",
            "--requests", "2", "--prompt-len", "8", "--max-new", "8"]
    serve.main(argv + (["--tree", "--temperature", "0.7"] if tree else []))
    out = capsys.readouterr().out
    assert "quantized weights=int4 target=yes kv=int8" in out
    assert ("tree SD: tau=" if tree else "served 2 requests; tau=") in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama2-7b-chat", "--reduced", "--device", "cpu",
                    "--quant-target"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama2-7b-chat", "--reduced", "--device", "cpu",
                    "--quant-weights", "int8", "--no-draft"])


def test_quantized_build_keeps_the_unquantized_init():
    """A model quantized from float32 weights holds the same embedding and
    norms as the bf16 model the unquantized path draws, and int8/uint8
    quantized matmul weights; unquantized target weights equal bf16 init."""
    from repro_torch.configs import QuantConfig
    plain = serve.build_models("llama2-7b-chat", True, "cpu")
    quant = serve.build_models("llama2-7b-chat", True, "cpu",
                               QuantConfig(weights="int8"), quant_target=False,
                               calib_seqs=2, calib_len=8)
    assert quant[4] == plain[4]
    (_, tp, _, dp, _), (_, tq, _, dq, _) = plain, quant
    assert torch.equal(tq["embed"], tp["embed"]) and tq["embed"].dtype == torch.bfloat16
    assert torch.equal(tq["layers"][1]["attn"]["wq"], tp["layers"][1]["attn"]["wq"])
    assert torch.equal(dq["embed"], dp["embed"])
    assert torch.equal(dq["final_norm"], dp["final_norm"])
    assert dq["lm_head"].q.dtype == torch.int8 and dq["lm_head"].pre is not None

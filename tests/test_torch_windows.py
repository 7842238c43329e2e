"""Sliding windows, long-context windows and scaled embeddings (Gemma-2)
in the port against ``repro``, on the CPU in float32.

Both packages get the same weights (the reference's seeded init carried
over by ``bridge.params_from_jax``) and the same seeded numpy inputs.
Attention outputs and logits must agree within 2e-5 of their scale (only
the order of sums differs); cache positions, tokens and accept counts must
be equal. The port's kernels run their plain versions here.

The reference's window-sized ring is copied with its arithmetic: a decode
call of T > 1 writes all T entries before it attends, so in a ring
narrower than the positions it holds the call overwrites the oldest
in-window keys of its own earlier queries. The serving paths of both
packages build their dense caches by ``prefill(cache_len=max_total)``,
wide enough for every position, so they never wrap; the tests show both
facts.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import speculative as jspec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.quant import calib as jcalib
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro.spectree.tree import tree_attn_mask as jtree_mask
from repro_torch.bridge import params_from_jax
from repro_torch.core import speculative as tspec
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import softcap
from repro_torch.models.model import Model as TModel
from repro_torch.quant import calib as tcalib
from repro_torch.serving import (ContinuousEngine, Request, ServeRequest,
                                 ServingEngine)
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec
from torch_paged import (MAXP, PAGE, PLEN, check_pool, chain_noise, jpool,
                         page_tables, random_pool, tpool)
from torch_parity import gumbel, one_torch_thread, port_config, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 2e-5          # of the output's scale, float32 on both sides
KEY = jax.random.PRNGKey(0)
P, NEW = 40, 16     # a prompt past the reduced window of 32 slots


@functools.lru_cache(maxsize=None)
def jitted(fn, *static):
    """The reference's ``fn`` under ``jax.jit`` with the named arguments
    static, one per (fn, static): called eagerly, its scans compile at every
    call; jitted, once a shape. A window passed as an argument is traced,
    so that every width shares one compile."""
    return jax.jit(fn, static_argnames=static)


def close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


# ------------------------------------------------------------ attention

def attn_cfg(**kw):
    """The reference model test's attention config (d 64, 4 heads on 2),
    in float32."""
    base = dict(name="a", arch_type="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=32,
                attn_chunk=8, dtype="float32")
    base.update(kw)
    return JConfig(**base)


def attn_pair(**kw):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = attn_cfg(**kw)
    jp, _ = jattn.init_attention(KEY, jcfg, jnp.float32)
    return jcfg, jp, port_config(jcfg), {k: tensor(v) for k, v in jp.items()}


def inputs(B, S, d=64, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def test_sliding_window_masks_distant_tokens():
    """The port of ``test_models.py::test_sliding_window_masks_distant_
    tokens``, with the outputs held to the reference's."""
    jcfg, jp, cfg, tp = attn_pair(attn_chunk=32)
    x = inputs(1, 32)
    pos = torch.arange(32)
    x2 = x.copy()
    x2[:, 0] += 10.0
    y_w = tattn.causal_attention(tp, tensor(x), pos, cfg, window=4)
    y_w2 = tattn.causal_attention(tp, tensor(x2), pos, cfg, window=4)
    assert torch.allclose(y_w[:, 8:], y_w2[:, 8:], atol=1e-5)
    y_full = tattn.causal_attention(tp, tensor(x), pos, cfg)
    y_full2 = tattn.causal_attention(tp, tensor(x2), pos, cfg)
    assert not torch.allclose(y_full[:, 8:], y_full2[:, 8:], atol=1e-3)
    close(y_w, jitted(jattn.causal_attention, "cfg")(
        jp, jnp.asarray(x), jnp.arange(32), jcfg, window=4))


def test_ring_cache_prefill_longer_than_cache():
    """The port of ``test_models.py::test_ring_cache_prefill_longer_than_
    cache``: prefill with S > cache_len keeps exactly the last cache_len
    positions, at the reference's slots."""
    jcfg, jp, cfg, tp = attn_pair(attn_chunk=8, sliding_window=8)
    x = inputs(1, 32)
    _, cache = tattn.prefill_attention(tp, tensor(x), torch.arange(32), cfg,
                                       cache_len=8, window=8)
    kept = sorted(int(p) for p in cache["pos"][0] if p >= 0)
    assert kept == list(range(24, 32))
    _, jcache = jitted(jattn.prefill_attention, "cfg", "cache_len")(
        jp, jnp.asarray(x), jnp.arange(32), jcfg, cache_len=8, window=8)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    close(cache["k"], jcache["k"])


def test_softcap_bounds_scores():
    """The port of ``test_models.py::test_softcap_bounds_scores``."""
    x = torch.linspace(-1000, 1000, 101)
    y = softcap(x, 50.0)
    assert float(y.abs().max()) <= 50.0
    assert torch.equal(softcap(x, None), x)


@pytest.mark.parametrize("window", [None, 5, 12])
def test_causal_and_prefill_window_parity(window):
    """Training and prefill attention with a window, softcapped, over 3
    query chunks; prefill into a cache wider than the prompt and into a
    ring narrower than it."""
    jcfg, jp, cfg, tp = attn_pair(attn_softcap=50.0)
    x = inputs(2, 24)
    pos = np.tile(np.arange(24), (2, 1)) + np.array([[0], [3]])
    xt, pt = tensor(x), tensor(pos, torch.long)
    xj, pj = jnp.asarray(x), jnp.asarray(pos, jnp.int32)
    close(tattn.causal_attention(tp, xt, pt, cfg, window),
          jitted(jattn.causal_attention, "cfg")(jp, xj, pj, jcfg,
                                                           window))
    for cache_len in (32, 16):
        out, cache = tattn.prefill_attention(tp, xt, pt, cfg, cache_len, window)
        jout, jcache = jitted(jattn.prefill_attention, "cfg", "cache_len")(
            jp, xj, pj, jcfg, cache_len, window)
        close(out, jout)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        close(cache["k"], jcache["k"])
        close(cache["v"], jcache["v"])


def test_decode_window_on_a_wrapped_ring_copies_the_reference():
    """A window-sized ring (16 slots, window 16) after a 20-position
    prefill: T = 1 and T = 4 decode calls equal the reference's. Four
    T = 1 calls give windowed causal attention over the whole sequence;
    the T = 4 call does not at its first queries, because its writes evict
    keys those queries still see (the reference's arithmetic), and agrees
    at its last."""
    W = 16
    jcfg, jp, cfg, tp = attn_pair()
    x = inputs(2, 24)
    xt, xj = tensor(x), jnp.asarray(x)
    pos = np.tile(np.arange(24), (2, 1))

    def prefill():
        _, c = tattn.prefill_attention(tp, xt[:, :20], torch.arange(20), cfg,
                                       W, W)
        _, jc = jitted(jattn.prefill_attention, "cfg", "cache_len")(
            jp, xj[:, :20], jnp.arange(20), jcfg, W, W)
        return c, jc

    cache, jcache = prefill()
    p4 = pos[:, 20:24]
    out4, cache = tattn.decode_attention(tp, xt[:, 20:24], cache,
                                         tensor(p4, torch.long), cfg, W)
    jdecode = jitted(jattn.decode_attention, "cfg")
    jout4, jcache = jdecode(jp, xj[:, 20:24], jcache,
                            jnp.asarray(p4, jnp.int32), jcfg, W)
    close(out4, jout4)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    close(cache["k"], jcache["k"])

    cache, jcache = prefill()
    singles = []
    for t in range(20, 24):
        p1 = pos[:, t:t + 1]
        o, cache = tattn.decode_attention(tp, xt[:, t:t + 1], cache,
                                          tensor(p1, torch.long), cfg, W)
        jo, jcache = jdecode(jp, xj[:, t:t + 1], jcache,
                             jnp.asarray(p1, jnp.int32), jcfg, W)
        close(o, jo)
        singles.append(o)
    singles = torch.cat(singles, dim=1)
    full = tattn.causal_attention(tp, xt, torch.arange(24), cfg, W)[:, 20:]
    close(singles, full.numpy())
    lost = (out4 - singles).abs().amax(dim=(0, 2))
    scale = float(singles.abs().max())
    assert lost[0] > 1e-3 * scale and lost[-1] <= REL * scale, lost


@pytest.mark.parametrize("tree", [False, True])
def test_paged_decode_window_parity(tree):
    """Paged decode over shared prefix pages, an inactive row and null-page
    columns, under a window of 8 that masks the oldest committed positions:
    positional causality (T 3) and a tree's ancestor mask (7 nodes)."""
    jcfg, jp, cfg, tp = attn_pair(attn_softcap=50.0)
    W = 8
    rng = np.random.default_rng(7)
    table = page_tables()
    table[2] = 0
    lengths = np.array(PLEN)
    leaves = random_pool(rng, 2, 16, False, table, lengths)
    kw_j, kw_t = {}, {}
    if tree:
        spec = JTreeSpec((2, 2))
        T = spec.num_nodes
        pos = lengths[:, None] + np.asarray(spec.depths())[None]
        slots = lengths[:, None] + np.arange(T)[None]
        mask = np.asarray(jtree_mask(spec, 0, T, jnp.asarray(lengths),
                                     MAXP * PAGE))
        kw_j = {"slots": jnp.asarray(slots, jnp.int32),
                "attn_mask": jnp.asarray(mask)}
        kw_t = {"slots": tensor(slots, torch.long), "attn_mask": tensor(mask)}
    else:
        T = 3
        pos = lengths[:, None] + np.arange(T)[None]
    x = rng.standard_normal((3, T, 64)).astype(np.float32)
    jout, jnew = jitted(jattn.paged_decode_attention, "cfg")(
        jp, jnp.asarray(x), jpool(leaves)["rem"][0], jnp.asarray(table),
        jnp.asarray(pos, jnp.int32), jcfg, W, **kw_j)
    tout, tnew = tattn.paged_decode_attention(
        tp, tensor(x), tpool(leaves)[0], tensor(table),
        tensor(pos, torch.long), cfg, W, **kw_t)
    close(tout[:2], np.asarray(jout)[:2])
    assert torch.isfinite(tout).all()
    check_pool(tnew, jnew)
    assert not tnew["k"][0].any()            # the null page stays zero
    # the window matters: without it the active rows attend otherwise
    wide, _ = tattn.paged_decode_attention(
        tp, tensor(x), tpool(leaves)[0], tensor(table),
        tensor(pos, torch.long), cfg, **kw_t)
    assert (wide[:2] - tout[:2]).abs().max() > 1e-3


# ------------------------------------------------------------ the model

def seeded_params(jm, seed):
    """Parameters in the reference's tree (its init's shapes, traced but
    not run: compiling its init costs seconds), drawn with numpy: N(0, 1)
    embeddings, matrices N(0, 1/fan_in), norm offsets N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], KEY)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = (1.0 if "embed" in name else 0.1 if "norm" in name
               else leaf.shape[-2] ** -0.5)
        return std * rng.standard_normal(leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def gemma():
    """Reduced Gemma-2 (2 layers: local_attn then attn, window 32, long
    context window 64, softcaps 50/30, scaled embeddings) in float32 on
    both sides, and a drafter of the same config from seed 1:
    {"j": [jt, jtp, jd, jdp], "t": [tt, ttp, td, tdp]}."""
    jcfg = jcfgs.reduced(jcfgs.get_config("gemma2-9b")).replace(dtype="float32")
    out = {"j": [], "t": []}
    for seed in (0, 1):
        jm = JModel(jcfg)
        jp = seeded_params(jm, seed)
        tm = TModel(port_config(jcfg), device="cpu")
        out["j"] += [jm, jax.tree.map(jnp.asarray, jp)]
        out["t"] += [tm, params_from_jax(jp, tm.cfg, "cpu")]
    return out


TOKS = np.random.default_rng(3).integers(0, 512, (2, 80)).astype(np.int32)
NXT = np.random.default_rng(4).integers(0, 512, (2, 3)).astype(np.int32)
NXT_POS = 80 + np.tile(np.arange(3), (2, 1))


@pytest.fixture(scope="module")
def ref_logits(gemma):
    """The reference target's logits on TOKS: training mode, and prefill
    into 88 slots then a 3-token decode past both windows, with and without
    long context: {"train": ..., False: (prefill, decode), True: ...}."""
    jt, jtp = gemma["j"][:2]
    toks = jnp.asarray(TOKS)
    out = {"train": jitted(jt.logits)(jtp, toks)[0]}
    for lc in (False, True):
        lg, c = jitted(jt.prefill, "cache_len", "long_context")(
            jtp, toks, cache_len=88, long_context=lc)
        d, _ = jitted(jt.decode_step, "long_context")(
            jtp, jnp.asarray(NXT), jnp.asarray(NXT_POS, jnp.int32), c,
            long_context=lc)
        out[lc] = (lg, d)
    return out


def test_reduced_gemma_config():
    cfg = port_config(jcfgs.reduced(jcfgs.get_config("gemma2-9b")))
    assert tfm.layer_kinds(cfg) == ("local_attn", "attn")
    assert tfm.layer_windows(cfg) == [32, None]
    assert tfm.layer_windows(cfg, long_context=True) == [32, 64]
    assert cfg.scale_embed and cfg.attn_softcap == 50.0


def test_scale_embed_logits(gemma, ref_logits):
    """Training logits with scaled embeddings equal the reference's (prefill
    and decode: the next test); without the scale they differ."""
    tt, ttp = gemma["t"][:2]
    toks = tensor(TOKS, torch.long)
    got = tt.logits(ttp, toks)
    close(got, ref_logits["train"])
    plain = TModel(tt.cfg.replace(scale_embed=False), device="cpu")
    assert (plain.logits(ttp, toks) - got).abs().max() > 1e-2


@pytest.mark.parametrize("long_context", [False, True])
def test_long_context_cache_widths_and_logits(gemma, ref_logits,
                                              long_context):
    """``init_cache`` sizes each layer's ring at min(max_len, window) as
    the reference does (the global layer windows at 64 in long-context
    mode); prefill and decode past both windows, with scaled embeddings,
    give the reference's logits."""
    jt, jtp = gemma["j"][:2]
    tt, ttp = gemma["t"][:2]
    for max_len in (16, 48, 96):
        jc = jt.init_cache(2, max_len, long_context=long_context)["groups"]
        tc = tt.init_cache(2, max_len, long_context=long_context)
        assert [c["pos"].shape[-1] for c in tc] == \
            [c["pos"].shape[-1] for c in jc]
        assert all(c["k"].shape[1] == c["pos"].shape[-1] for c in tc)
    lg, c = tt.prefill(ttp, tensor(TOKS, torch.long), cache_len=88,
                       long_context=long_context)
    jlg, jd = ref_logits[long_context]
    close(lg, jlg)
    d, _ = tt.decode_step(ttp, tensor(NXT, torch.long),
                          tensor(NXT_POS, torch.long), c,
                          long_context=long_context)
    close(d, jd)


def test_mixed_width_caches_refuse_a_tree_round(gemma):
    """Caches from ``init_cache`` with max_len above the 32-slot window mix
    a 32-slot ring with a 64-slot cache: both packages refuse the tree
    round with the same ValueError. The trim of a chain rewind keys on
    positions and takes such caches."""
    jt, jtp, jd, jdp = gemma["j"]
    tt, ttp, td, tdp = gemma["t"]
    B = 2
    tokens = np.zeros((B, 64), np.int32)
    jstate = {"tokens": jnp.asarray(tokens), "lengths": jnp.full((B,), 8, jnp.int32),
              "pending": jnp.ones((B,), jnp.int32),
              "t_cache": jt.init_cache(B, 64), "d_cache": jd.init_cache(B, 64)}
    tstate = {"tokens": tensor(tokens, torch.long),
              "lengths": torch.full((B,), 8), "pending": torch.ones(B, dtype=torch.long),
              "t_cache": tt.init_cache(B, 64), "d_cache": td.init_cache(B, 64)}
    assert [c["pos"].shape[1] for c in tstate["t_cache"]] == [32, 64]
    msg = "mixed sliding-window caches are unsupported"
    with pytest.raises(ValueError, match=msg):
        jround.tree_round(jd, jt, jspec.SDConfig(temperature=0.7),
                          JTreeSpec((2, 2)), jdp, jtp, jstate, KEY)
    with pytest.raises(ValueError, match=msg):
        tround.tree_round(td, tt, tspec.SDConfig(temperature=0.7),
                          TreeSpec((2, 2)), tdp, ttp, tstate,
                          torch.Generator().manual_seed(0))
    cache = tstate["t_cache"]
    for c in cache:
        c["pos"][:] = torch.arange(c["pos"].shape[1])
    tspec.trim_attn_cache(cache, torch.tensor([5, 40]))
    for c in cache:
        W = c["pos"].shape[1]
        assert (c["pos"][0] == torch.where(torch.arange(W) <= 5,
                                           torch.arange(W), -1)).all()
        assert (c["pos"][1] == torch.where(torch.arange(W) <= 40,
                                           torch.arange(W), -1)).all()


@pytest.mark.parametrize("long_context,P", [(False, 72), (True, 130)])
def test_static_generation_past_the_window_equals_ar(gemma, long_context, P):
    """Temperature 0, prompts of 72 tokens past the 32-slot window, or of
    130 past the 64-slot long-context window too (where long_context
    changes the tokens), 16 new: chain (drafter, and the target as
    its own drafter) and tree tokens equal AR (the prefill caches hold
    every position), and so do the static engine's chain and AR, which
    take ``sd.long_context``. Without long context, AR and the
    drafter's chain
    tokens equal the reference's token for token (with it, the layers'
    logits are held to the reference's above)."""
    jt, jtp, jd, jdp = gemma["j"]
    tt, ttp, td, tdp = gemma["t"]
    seed = 6 if long_context else 5
    prompt = np.random.default_rng(seed).integers(3, 512, (2, P)).astype(np.int32)
    tpr = tensor(prompt, torch.long)
    n = P + NEW
    tar, _ = tspec.autoregressive_generate(tt, ttp, tpr, NEW, temperature=0.0,
                                           long_context=long_context)
    if long_context:
        plain, _ = tspec.autoregressive_generate(tt, ttp, tpr, NEW,
                                                 temperature=0.0)
        assert not torch.equal(plain, tar)
    tsdc = tspec.SDConfig(gamma=3, temperature=0.0, long_context=long_context)
    for drafter, dp in ((td, tdp), (tt, ttp)):
        ttok, tstats = tspec.speculative_generate(drafter, tt, dp, ttp, tpr,
                                                  NEW, tsdc)
        assert torch.equal(ttok[:, :n], tar)
    assert tstats.tau > 3.0                  # the target as its own drafter
    for drafter, dp in ((td, tdp), (tt, ttp)):
        ttree, _ = tround.tree_speculative_generate(
            drafter, tt, dp, ttp, tpr, NEW, tsdc, TreeSpec((2, 2)))
        assert torch.equal(ttree[:, :n], tar)
    # the static engine's one switch, sd.long_context, reaches the chain
    # and AR paths
    for drafter, dp in ((td, tdp), (None, None)):
        engine = ServingEngine(target=tt, target_params=ttp, draft=drafter,
                               draft_params=dp, sd=tsdc)
        assert engine.long_context == long_context
        got = engine.serve([Request(prompt=p, max_new_tokens=NEW, request_id=i)
                            for i, p in enumerate(prompt.astype(np.int64))])
        for r in got:
            np.testing.assert_array_equal(r.tokens,
                                          tar[r.request_id, P:].numpy())
    if long_context:
        return
    jpr = jnp.asarray(prompt)
    jar, _ = jspec.autoregressive_generate(jt, jtp, jpr, NEW, temperature=0.0)
    assert np.array_equal(tar.numpy(), np.asarray(jar))
    jtok, jstats = jspec.speculative_generate(
        jd, jt, jdp, jtp, jpr, NEW, jspec.SDConfig(gamma=3, temperature=0.0))
    ttok, tstats = tspec.speculative_generate(td, tt, tdp, ttp, tpr, NEW, tsdc)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats.tau == jstats.tau


def test_chain_rounds_past_the_window_at_temp07_with_reference_draws(gemma):
    """Three chain rounds at temperature 0.7 from a 40-token prompt, each
    fed the draws the reference makes from its round key: tokens, accept
    counts, lengths and both caches equal the reference's after every
    round."""
    jt, jtp, jd, jdp = gemma["j"]
    tt, ttp, td, tdp = gemma["t"]
    prompt = np.random.default_rng(6).integers(3, 512, (2, P)).astype(np.int32)
    k0, key = jax.random.split(jax.random.PRNGKey(11))
    jsdc = jspec.SDConfig(gamma=3, temperature=0.7)
    tsdc = tspec.SDConfig(gamma=3, temperature=0.7)
    max_total = P + NEW + 5
    jst = jitted(jspec._prefill_state, "draft", "target", "max_total", "sdc")(
        jd, jt, jdp, jtp, jnp.asarray(prompt), max_total, jsdc, k0)
    tst = tspec._prefill_state(td, tt, tdp, ttp, tensor(prompt, torch.long),
                               max_total, tsdc, None,
                               noise=tensor(gumbel(k0, (2, 512))))
    jround_fn = jax.jit(lambda st, k: jspec.sd_round(jd, jt, jsdc, jdp, jtp,
                                                      st, k))
    for _ in range(3):
        key, kr = jax.random.split(key)
        jst, jn = jround_fn(jst, kr)
        tst, tn = tspec.sd_round(td, tt, tsdc, tdp, ttp, tst, None,
                                 chain_noise(kr, 3, 512, rows=2))
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        for name in ("tokens", "lengths", "pending"):
            assert np.array_equal(tst[name].numpy(), np.asarray(jst[name])), name
        for cname in ("t_cache", "d_cache"):
            jc = jst[cname]["groups"]
            for i, layer in enumerate(tst[cname]):
                jl = jc[i % 2]
                assert np.array_equal(layer["pos"].numpy(),
                                      np.asarray(jl["pos"][i // 2]))
                close(layer["k"], jl["k"][i // 2])
    assert int(tst["lengths"].min()) > 40


@pytest.mark.parametrize("long_context,lens,seed", [
    (False, (40, 52, 45), 8), (True, (130, 140, 126), 14)])
def test_paged_continuous_past_the_window_equals_static_ar(gemma, long_context,
                                                           lens, seed):
    """Temperature 0, 3 requests through 2 slots of 8-slot pages and
    16-token prefill chunks, chain and tree: every request's tokens equal
    its static AR tokens, with the same ``long_context`` (whose window
    changes the first request's tokens). The pages keep every position;
    the window only masks."""
    tt, ttp, td, tdp = gemma["t"]
    rng = np.random.default_rng(seed)
    news = (12, 10, 14)
    prompts = [rng.integers(3, 512, n).astype(np.int64) for n in lens]

    def ar(p, m, lc):
        return tspec.autoregressive_generate(
            tt, ttp, tensor(p[None], torch.long), m, temperature=0.0,
            long_context=lc)[0][0, len(p):].numpy()

    greedy = [ar(p, m, long_context) for p, m in zip(prompts, news)]
    if long_context:
        assert not np.array_equal(ar(prompts[0], news[0], False), greedy[0])
    sdc = tspec.SDConfig(gamma=3, temperature=0.0, long_context=long_context)
    for tree in (None, TreeSpec((2, 2))):
        engine = ContinuousEngine(
            target=tt, target_params=ttp, draft=td, draft_params=tdp, sd=sdc,
            tree=tree, max_batch=2, page_size=8, prefill_chunk=16,
            max_seq_len=max(lens) + max(news))
        got = {r.request_id: r.tokens for r in engine.serve(
            [ServeRequest(prompt=p, max_new_tokens=m, request_id=i)
             for i, (p, m) in enumerate(zip(prompts, news))])}
        assert engine.telemetry.max_queue_depth >= 1
        for i, want in enumerate(greedy):
            np.testing.assert_array_equal(got[i], want)


# ------------------------------------------------------------ calibration

def port_key(jkey):
    """The reference's key path over its unstacked groups (group r, kind
    k of the pattern (local_attn, attn)) -> the port's layer 2r + k."""
    m = re.match(r"\['groups'\]\[(\d+)\]\[(\d+)\](.*)", jkey)
    return f"['layers'][{2 * int(m[1]) + int(m[2])}]{m[3]}" if m else jkey


def test_int8_calibration_scales_the_embeddings(gemma, monkeypatch):
    """AWQ calibration of reduced Gemma-2 sees the scaled embeddings and
    the windows: the port's activation stats equal those the reference's
    ``quantize_params`` collects, and the reference's int8 model gives the
    same logits in both packages. The reference's int8 matmul runs through
    its plain oracle here (its Pallas kernel in interpret mode is held to
    the port in ``test_torch_quant.py``)."""
    jt, jtp = gemma["j"][:2]
    tt, ttp = gemma["t"][:2]
    calib = np.random.default_rng(9).integers(3, 512, (4, 48)).astype(np.int32)
    seen = {}
    collect = jcalib.collect_act_stats

    def recording(*args, **kw):
        seen.update(collect(*args, **kw))
        return seen

    monkeypatch.setattr(jcalib, "collect_act_stats", recording)
    monkeypatch.setattr(jops.qk, "quant_matmul",
                        lambda x, q, scale, *, bits, group=0, interpret=True:
                        jref.ref_quant_matmul(x, q, scale, bits, group))
    jq = jcalib.quantize_params(jt, jtp, JQuantConfig(weights="int8"),
                                calib_tokens=calib)
    tstats = tcalib.collect_act_stats(ttp, tt.cfg, calib)
    assert len(seen) == 7 * 2 + 1 and set(tstats) == {port_key(k) for k in seen}
    for k, v in seen.items():
        np.testing.assert_allclose(tstats[port_key(k)], v, rtol=1e-5, atol=1e-6)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tt.cfg, "cpu")
    toks = calib[:2, :40]
    jlg, jc = jitted(jt.prefill, "cache_len", "long_context")(
        jq, jnp.asarray(toks), cache_len=48)
    tlg, tc = tt.prefill(tq, tensor(toks, torch.long), cache_len=48)
    close(tlg, jlg, 1e-5)
    pos = np.full((2, 1), 40, np.int32)
    jd, _ = jitted(jt.decode_step, "long_context")(
        jq, jnp.asarray(toks[:, :1]), jnp.asarray(pos), jc)
    td, _ = tt.decode_step(tq, tensor(toks[:, :1], torch.long),
                           tensor(pos, torch.long), tc)
    close(td, jd, 1e-5)
    assert all(n == 0 for n in ops.LAUNCHES.values())    # CPU: plain version

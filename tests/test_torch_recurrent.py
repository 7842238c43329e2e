"""The port's recurrent layers and hybrids (``models/ssm.py``,
``models/xlstm.py``, zamba2's shared attention, the chain round's
rewind by snapshots) against ``repro``, on the CPU in float32.

Both packages get the same weights (drawn with numpy into the reference's
tree, ``seeded_params``, carried over by ``bridge.params_from_jax``) and
the same seeded numpy inputs.
Outputs must agree within 2e-5 of their scale: float32 on both sides,
only the order of sums differs. The chunked scans are also held to their
step recurrence, written out here, within 1e-4 (the reference test's
tolerance). Tokens, accept counts and cache positions must be equal.
Reference calls are jitted once a shape (``jitted``, as in
test_torch_windows.py): eager, their scans would compile at every call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import speculative as jspec
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.bridge import params_from_jax
from repro_torch.core import speculative as tspec
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.model import Model as TModel
from torch_parity import gumbel, one_torch_thread, port_config, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 2e-5          # of the output's scale, float32 on both sides
REC_TOL = 1e-4      # chunked scan against its step recurrence (reference)
G = 3


@functools.lru_cache(maxsize=None)
def jitted(fn, *static):
    """The reference's ``fn`` under ``jax.jit``, once per (fn, static)."""
    return jax.jit(fn, static_argnames=static)


def close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


# ------------------------------------------------------------ chunked scans

def ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return (randn(rng, B, S, H, P), randn(rng, B, S, N), randn(rng, B, S, N),
            softplus(randn(rng, B, S, H)), -softplus(randn(rng, B, S, H)))


def naive_ssd(xh, Bm, Cm, dt, ld):
    """The step recurrence of ``test_models.py::_naive_ssd``, in torch."""
    B, S, H, P = xh.shape
    h = torch.zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        h = torch.exp(ld[:, t])[:, :, None, None] * h + torch.einsum(
            "bn,bhp,bh->bhpn", Bm[:, t], xh[:, t], dt[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("chunk", [4, 8, 24, 7])
def test_chunked_ssd_matches_recurrence(chunk):
    """The port of ``test_models.py::test_chunked_ssd_matches_recurrence``
    (chunk 7 does not divide 24: one chunk), and the reference's output."""
    args = ssd_inputs(2, 24, 3, 4, 5)
    y, hT = tssm.chunked_ssd(*map(tensor, args), chunk)
    yn, hn = naive_ssd(*map(tensor, args))
    assert torch.allclose(y, yn, atol=REC_TOL)
    assert torch.allclose(hT, hn, atol=REC_TOL)
    jy, jh = jitted(jssm.chunked_ssd, "chunk")(*map(jnp.asarray, args),
                                               chunk=chunk)
    close(y, jy)
    close(hT, jh)


def test_chunked_ssd_grads_finite():
    """The port of ``test_models.py::test_chunked_ssd_grads_finite``: the
    double where keeps the backward finite; every input's gradient equals
    ``jax.grad``'s within 1e-5 of its scale."""
    args = ssd_inputs(1, 16, 2, 4, 4, seed=1)
    ts = [tensor(a).requires_grad_() for a in args]
    tssm.chunked_ssd(*ts, 8)[0].sum().backward()
    want = jax.jit(jax.grad(lambda *a: jssm.chunked_ssd(*a, 8)[0].sum(),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        close(t.grad, w, 1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_chunked_gla_matches_recurrence(chunk):
    """The port of ``test_models.py::test_chunked_gla_matches_recurrence``,
    and the reference's output."""
    rng = np.random.default_rng(2)
    B, S, H, N, P = 2, 24, 2, 4, 5
    k, q, v = randn(rng, B, S, H, N), randn(rng, B, S, H, N), randn(rng, B, S, H, P)
    gi = 1.0 / (1.0 + np.exp(-randn(rng, B, S, H)))
    lf = -softplus(-randn(rng, B, S, H))
    y, hT = txlstm.chunked_gla(*map(tensor, (v, k, q, gi, lf)), chunk)
    h = torch.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        h = torch.exp(tensor(lf[:, t]))[:, :, None, None] * h + torch.einsum(
            "bhn,bhp,bh->bhnp", *map(tensor, (k[:, t], v[:, t], gi[:, t])))
        ys.append(torch.einsum("bhn,bhnp->bhp", tensor(q[:, t]), h))
    assert torch.allclose(y, torch.stack(ys, 1), atol=REC_TOL)
    assert torch.allclose(hT, h, atol=REC_TOL)
    jy, jh = jitted(jxlstm.chunked_gla, "chunk")(
        *map(jnp.asarray, (v, k, q, gi, lf)), chunk=chunk)
    close(y, jy)
    close(hT, jh)


# ------------------------------------------------------------ the blocks

BLOCK_CFG = jcfgs.reduced(jcfgs.get_config("zamba2-7b")).replace(
    dtype="float32", ssm_chunk=8)
XLSTM_CFG = jcfgs.reduced(jcfgs.get_config("xlstm-1.3b")).replace(
    dtype="float32", ssm_chunk=8)


def block_params(kind):
    """(reference cfg, reference params, port cfg, port params) of one
    block, the zero-initialised norms and biases drawn at random so that
    they matter."""
    cfg = XLSTM_CFG if kind in ("mlstm", "slstm") else BLOCK_CFG
    init = {"mamba": jssm.init_mamba, "mlstm": jxlstm.init_mlstm,
            "slstm": jxlstm.init_slstm}[kind]
    jp, _ = init(jax.random.PRNGKey(4), cfg, jnp.float32)
    rng = np.random.default_rng(5)
    np_p = {k: (0.3 * randn(rng, *np.shape(v)) if k in ("norm_w", "conv_b",
                                                         "b_gates", "dt_bias")
                else np.asarray(v)) for k, v in jp.items()}
    return cfg, {k: jnp.asarray(v) for k, v in np_p.items()}, \
        port_config(cfg), {k: tensor(v) for k, v in np_p.items()}


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def state_leaves(st):
    """A block's state as a list: (state, tail), a tensor, or a carry dict."""
    if isinstance(st, dict):
        return [st[k] for k in sorted(st)]
    return list(st) if isinstance(st, tuple) else [st]


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_blocks_match_the_reference(kind):
    """The chunked forward of 24 tokens (3 chunks), then decode steps of 1
    and 3 tokens from its state, against the reference's, within 2e-5 of
    scale; the port's decode from the forward's state equals its own
    forward over the longer input."""
    jcfg, jp, cfg, tp = block_params(kind)
    rng = np.random.default_rng(6)
    x = randn(rng, 2, 24, jcfg.d_model)
    x2 = randn(rng, 2, 4, jcfg.d_model)
    if kind == "mamba":
        y, st = tssm.mamba_forward(tp, tensor(x), cfg)
        jy, jst = jitted(jssm.mamba_forward, "cfg")(jp, jnp.asarray(x), jcfg)
        steps = [(lambda s, xs: tssm.mamba_decode(tp, tensor(xs), cfg, *s),
                  lambda s, xs: jitted(jssm.mamba_decode, "cfg")(
                      jp, jnp.asarray(xs), jcfg, *s))]
    elif kind == "mlstm":
        y, st = txlstm.mlstm_forward(tp, tensor(x), cfg)
        jy, jst = jitted(jxlstm.mlstm_forward, "cfg")(jp, jnp.asarray(x), jcfg)
        steps = [(lambda s, xs: txlstm.mlstm_decode(tp, tensor(xs), cfg, s),
                  lambda s, xs: jitted(jxlstm.mlstm_decode, "cfg")(
                      jp, jnp.asarray(xs), jcfg, s))]
    else:
        y, st = txlstm.slstm_forward(tp, tensor(x), cfg)
        jy, jst = jitted(jxlstm.slstm_forward, "cfg")(jp, jnp.asarray(x), jcfg)
        steps = [(lambda s, xs: txlstm.slstm_forward(tp, tensor(xs), cfg, s),
                  lambda s, xs: jitted(jxlstm.slstm_forward, "cfg")(
                      jp, jnp.asarray(xs), jcfg, s))]
    close(y, jy)
    tdec, jdec = steps[0]
    ts, js = st, jst
    outs = []
    for lo, hi in ((0, 1), (1, 4)):
        ty, ts = tdec(ts, x2[:, lo:hi])
        jyy, js = jdec(js, x2[:, lo:hi])
        close(ty, jyy)
        outs.append(ty)
    for t_leaf, j_leaf in zip(state_leaves(ts), state_leaves(js)):
        close(t_leaf, j_leaf)
    full = {"mamba": lambda a: tssm.mamba_forward(tp, a, cfg),
            "mlstm": lambda a: txlstm.mlstm_forward(tp, a, cfg),
            "slstm": lambda a: txlstm.slstm_forward(tp, a, cfg)}[kind](
        tensor(np.concatenate([x, x2], 1)))[0]
    close(torch.cat(outs, 1), full[:, 24:].detach().numpy())


# ------------------------------------------------ chain rounds and rewind

def hybrid_cfgs():
    """A zamba2-family target of 7 blocks (two groups, so both shared sets
    run, and a Mamba remainder) and a narrower hybrid drafter of 4 blocks,
    float32."""
    base = jcfgs.reduced(jcfgs.get_config("zamba2-7b")).replace(
        dtype="float32")
    return (base.replace(num_layers=7),
            base.replace(name="hybrid-drafter", num_layers=4, d_model=64,
                         num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128))


def xlstm_cfgs():
    base = jcfgs.reduced(jcfgs.get_config("xlstm-1.3b")).replace(
        dtype="float32")
    return base, base.replace(name="xlstm-drafter", d_model=64, num_heads=2)


PAIRS = {"hybrid": hybrid_cfgs, "xlstm": xlstm_cfgs}


def seeded_params(jm, seed):
    """Parameters in the reference's tree (its init's shapes, traced but
    not run: running its init costs seconds a model), drawn with numpy:
    N(0, 1) embeddings, matrices N(0, 1/fan_in), norm offsets and biases
    N(0, 0.1^2), and the recurrent blocks' A_log, D, conv and gate biases
    about the reference's init values (log of 1..16, 1, scale 0.5, the
    forget bias 3)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, last = jax.tree_util.keystr(path), path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if last == "A_log":
            return np.log(rng.uniform(1.0, 16.0, leaf.shape)).astype(np.float32)
        if last == "D":
            return 1.0 + 0.1 * z
        if last == "b_if":      # input gates about 0, forget gates about 3
            nh = leaf.shape[-1] // 2
            return 0.1 * z + np.repeat(np.float32([0.0, 3.0]), nh)
        if last == "conv_w":
            return 0.5 * z
        if "embed" in name:
            return z
        if "norm" in name or last in ("dt_bias", "conv_b", "b_gates"):
            return 0.1 * z
        return z * leaf.shape[-2] ** -0.5
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def pair(name):
    """{"j": [jt, jtp, jd, jdp], "t": [tt, ttp, td, tdp]}, same weights."""
    out = {"j": [], "t": []}
    for cfg, seed in zip(PAIRS[name](), (0, 1)):
        jm = JModel(cfg)
        np_tree = seeded_params(jm, seed)
        tm = TModel(port_config(cfg), device="cpu")
        out["j"] += [jm, jax.tree.map(jnp.asarray, np_tree)]
        out["t"] += [tm, params_from_jax(np_tree, tm.cfg, "cpu")]
    return out


def port_layers(jcache, cfg):
    """The reference's {"groups", "rem"} cache as the port's list of layer
    dicts (numpy), an sLSTM's carry flattened."""
    g, n, rem = cfg.pattern_blocks()

    def one(tree):
        tree = as_np(tree)
        return dict(tree.get("carry", tree))
    out = [one(jax.tree.map(lambda a: a[r], jcache["groups"][k]))
           for r in range(n) for k in range(len(g))]
    return out + [one(c) for c in jcache["rem"]]


def check_cache(tcache, jcache, cfg):
    """Positions equal, keys and values equal where a position is held,
    recurrent leaves within 2e-5 of scale."""
    want = port_layers(jcache, cfg)
    assert len(tcache) == len(want)
    for t, j in zip(tcache, want):
        assert t.keys() == j.keys()
        if "pos" in t:
            assert np.array_equal(t["pos"].numpy(), j["pos"])
            held = j["pos"] >= 0
            for name in ("k", "v"):
                close(t[name].numpy()[held], j[name][held])
        else:
            for name in t:
                close(t[name], j[name])


def states(p, toks, cache_len, long_context, pending):
    """Both packages' round states after prefilling ``toks`` into caches
    of ``cache_len`` slots (a ring when the prompt is longer), with the
    same pending token."""
    jt, jtp, jd, jdp = p["j"]
    tt, ttp, td, tdp = p["t"]
    B, S = toks.shape
    buf = np.zeros((B, S + 16), np.int32)
    buf[:, :S] = toks
    jst = {"tokens": jnp.asarray(buf), "lengths": jnp.full((B,), S, jnp.int32),
           "pending": jnp.asarray(pending)}
    tst = {"tokens": tensor(buf, torch.long),
           "lengths": torch.full((B,), S, dtype=torch.long),
           "pending": tensor(pending, torch.long)}
    for name, jm, jmp, tm, tmp in (("t_cache", jt, jtp, tt, ttp),
                                   ("d_cache", jd, jdp, td, tdp)):
        jst[name] = jitted(jm.prefill, "cache_len", "long_context")(
            jmp, jnp.asarray(toks), cache_len=cache_len,
            long_context=long_context)[1]
        tst[name] = tm.prefill(tmp, tensor(toks, torch.long), cache_len,
                               long_context=long_context)[1]
        check_cache(tst[name], jst[name], tm.cfg)
    return jst, tst


def round_noise(key, B, V):
    keys = jax.random.split(key, G + 2)
    return {"draft": tensor(jnp.stack([gumbel(keys[j], (B, V))
                                       for j in range(G)])),
            "u": tensor(jax.random.uniform(keys[G], (G, B))),
            "residual": tensor(gumbel(keys[G + 1], (B, V)))}


CASES = {"hybrid": ("hybrid", False), "hybrid-long": ("hybrid", True),
         "xlstm": ("xlstm", False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_round_rewinds_to_the_reference_cache(case, monkeypatch):
    """Draft, verify and commit of one chain round at 0.7 with a recurrent
    drafter and target (the hybrid pair; the xLSTM pair), the port fed the
    reference's draws: the draft and target distributions within 1e-5,
    the drafted tokens, accept counts and tokens equal, and the rows that
    reject a draft rewind every Mamba state, conv tail, mLSTM state, sLSTM
    carry and attention cache to the reference's. In "hybrid-long" the
    prompt (80, five SSD chunks of 16) is longer than the long-context
    window (64) and the attention caches are window-sized rings, whose
    slots later feeds overwrite: the snapshots copy them, and a rewind by
    position alone gives other positions than the reference's."""
    name, long_context = CASES[case]
    p = pair(name)
    jt, jtp, jd, jdp = p["j"]
    tt, ttp, td, tdp = p["t"]
    B, V = 3, jt.cfg.vocab_size
    S = 80 if long_context else 12
    cache_len = jt.cfg.long_context_window if long_context else S + 16
    rng = np.random.default_rng(7)
    toks = rng.integers(3, V, (B, S)).astype(np.int32)
    pending = rng.integers(3, V, (B,)).astype(np.int32)
    kr = jax.random.PRNGKey(21)
    jsdc = jspec.SDConfig(gamma=G, temperature=0.7, long_context=long_context)
    tsdc = tspec.SDConfig(gamma=G, temperature=0.7, long_context=long_context)
    jst, tst = states(p, toks, cache_len, long_context, pending)
    ph = jspec._cached_phased_round(jd, jt, jsdc)
    jdr = ph["draft"](jdp, jtp, jst, kr)
    jver = ph["verify"](jtp, jst, jdr)
    jnew, jn = ph["commit"](jst, jdr, jver, kr)
    noise = round_noise(kr, B, V)
    tdr = tspec.sd_draft_phase(td, tsdc, tdp, tst, None, noise)
    tver = tspec.sd_verify_phase(tt, tsdc, ttp, tst, tdr)
    assert len(tdr["d_snaps"]) == len(tver["t_snaps"]) == G
    close(tdr["p_stack"], jdr["p_stack"], 1e-5)
    close(tver["q_stack"], jver["q_stack"], 1e-5)
    assert np.array_equal(tdr["x"].numpy(), np.asarray(jdr["x"]))
    tnew, tn = tspec.sd_commit_phase(tsdc, tst, tdr, tver, None, noise)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert (tn.numpy() < G - 1).any(), "no row rejected two drafts"
    for key in ("tokens", "lengths", "pending"):
        assert np.array_equal(tnew[key].numpy(), np.asarray(jnew[key])), key
    check_cache(tnew["t_cache"], jnew["t_cache"], tt.cfg)
    check_cache(tnew["d_cache"], jnew["d_cache"], td.cfg)
    rings = tspec.ring_layers(tt, tnew["t_cache"], long_context)
    assert any(rings) == long_context
    if long_context:    # the same round rewound by position only
        _, tst = states(p, toks, cache_len, long_context, pending)
        monkeypatch.setattr(tspec, "ring_layers",
                            lambda m, c, lc: [False] * len(c))
        tbad, _ = tspec.sd_round(td, tt, tsdc, tdp, ttp, tst, None, noise)
        with pytest.raises(AssertionError):
            check_cache(tbad["t_cache"], jnew["t_cache"], tt.cfg)

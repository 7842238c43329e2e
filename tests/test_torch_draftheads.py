"""The port's draft heads (``repro_torch.draftheads``) against the
reference's (``repro.draftheads``) at the reference test's tiny size: D 64,
4 heads, 2 KV heads, V 64, a 4-layer float32 target.

Both packages get the same parameters (the reference's, randomised from a
numpy seed so that Medusa's near-zero start and the zero norms do not hide
anything, through ``bridge.head_params_from_jax``/``params_from_jax``).
Outputs must agree within ``TOL`` = 1e-5 (float32 on both sides: only the
order of sums differs); tokens, lengths, pending tokens and accept counts
must be equal when the port is given the reference's random draws; greedy
tokens must be identical. The heads' distillation and the CLIs are in
test_torch_head_training.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_draft_heads as jload_heads
from repro.checkpoint import save_draft_heads as jsave_heads
from repro.configs.base import ModelConfig as JConfig
from repro.core import speculative as jspec
from repro.draftheads import drafter as jdrafter
from repro.draftheads import heads as jheads
from repro.models import Model as JModel
from repro.models.model import capture_hidden as jcapture
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro_torch.bridge import head_params_from_jax, params_from_jax
from repro_torch.checkpoint.io import load_draft_heads, save_draft_heads
from repro_torch.core import speculative as tspec
from repro_torch.draftheads import (HeadConfig, HeadDrafter, drafter as tdrafter,
                                    heads as theads, is_head_drafter)
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import capture_hidden
from repro_torch.serving import ContinuousEngine, ServeRequest
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from torch_paged import (ACTIVE, NP, PAGE, PLEN, SHARED, chain_noise,
                         check_pool, page_tables, tree_noise)
from torch_parity import TOL, gumbel, one_torch_thread, port_config, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KINDS = ("eagle", "medusa")
JCFG = JConfig(name="t", arch_type="dense", num_layers=4, d_model=64,
               num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
               attn_chunk=16, remat=False, dtype="float32")
V, D = JCFG.vocab_size, JCFG.d_model
B, S, G = 3, 12, 3                # rows (as in torch_paged), prompt, gamma
SPEC = (2, 2)


def flat(tree, prefix=()):
    """{key tuple: leaf} of a nested dict of parameters."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in flat(sub, prefix + (name,)).items()}
    return {prefix: tree}


def randomised(np_tree, rng):
    """A head tree of the same shapes with every leaf drawn from ``rng``:
    norms at 0.1, matrices at 1/sqrt(fan-in)."""
    def draw(path, a):
        scale = 0.1 if "norm" in path[-1] else 1.0 / np.sqrt(a.shape[-2])
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)
    out = {}
    for path, a in flat(np_tree).items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw(path, a)
    return out


@pytest.fixture(scope="module")
def target():
    """Reference and port target with the same float32 weights."""
    jt = JModel(JCFG)
    jtp, _ = jt.init(jax.random.PRNGKey(0))
    tt = TModel(port_config(JCFG), device="cpu")
    return jt, jtp, tt, params_from_jax(jax.tree.map(np.asarray, jtp),
                                        tt.cfg, "cpu")


@pytest.fixture(scope="module")
def heads():
    """{kind: (reference drafter, its params, port drafter, port params)}."""
    out = {}
    for i, kind in enumerate(KINDS):
        jh = jdrafter.HeadDrafter(jheads.HeadConfig.for_target(
            kind, JCFG, num_medusa_heads=4))
        np_hp = jax.tree.map(np.asarray, jh.init(jax.random.PRNGKey(2 + i)))
        np_hp = randomised(np_hp, np.random.default_rng(10 + i))
        th = HeadDrafter(HeadConfig(**dataclasses.asdict(jh.hc)))
        out[kind] = (jh, jax.tree.map(jnp.asarray, np_hp), th,
                     head_params_from_jax(np_hp, th.hc, "cpu"))
    return out


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def prompt(seed=3, n=B, s=S):
    return np.random.default_rng(seed).integers(3, V, (n, s)).astype(np.int32)


# ---------------------------------------------------------------- forwards

@pytest.mark.parametrize("kind", KINDS)
def test_head_forwards_match_reference(target, heads, kind):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 5, D)).astype(np.float32)
    if kind == "medusa":
        close(theads.medusa_logits(thp, ttp, tt.cfg, th.hc, tensor(h)),
              jheads.medusa_logits(jhp, jtp, JCFG, jh.hc, jnp.asarray(h)))
        return
    toks = rng.integers(0, V, (2, 5)).astype(np.int32)
    tx = theads.eagle_fuse(thp, ttp, tensor(h), tensor(toks, torch.long))
    jx = jheads.eagle_fuse(jhp, jtp, jnp.asarray(h), jnp.asarray(toks))
    close(tx, jx)
    # a level of a (2, 2) tree: nodes 3..6 over the 3 fused inputs before
    # them, under the ancestor mask
    spec = TTreeSpec(SPEC)
    hist = rng.standard_normal((2, 3, D)).astype(np.float32)
    x = rng.standard_normal((2, 4, D)).astype(np.float32)
    mask = np.broadcast_to(spec.ancestors()[3:7, :7], (2, 4, 7))
    tg = theads.eagle_block(thp, th.hc, tensor(x), tensor(hist), tensor(mask))
    jg = jheads.eagle_block(jhp, jh.hc, jnp.asarray(x), jnp.asarray(hist),
                            jnp.asarray(mask))
    close(tg, jg)
    close(theads.eagle_logits(thp, ttp, tt.cfg, th.hc, tg),
          jheads.eagle_logits(jhp, jtp, JCFG, jh.hc, jg))


def test_return_hidden_and_capture_hidden_match_reference(target):
    jt, jtp, tt, ttp = target
    toks = prompt()
    jl, jc, jh = jt.prefill(jtp, jnp.asarray(toks), cache_len=24,
                            return_hidden=True)
    tl, tc, th = tt.prefill(ttp, tensor(toks, torch.long), cache_len=24,
                            return_hidden=True)
    close(th, jh)
    close(tl, jl)
    assert len(tt.prefill(ttp, tensor(toks, torch.long), 24)) == 2
    new = prompt(seed=4, s=2)
    pos = np.tile(np.arange(S, S + 2), (B, 1)).astype(np.int32)
    jl, _, jh = jt.decode_step(jtp, jnp.asarray(new), jnp.asarray(pos), jc,
                               return_hidden=True)
    tl, _, th = tt.decode_step(ttp, tensor(new, torch.long),
                               tensor(pos, torch.long), tc, return_hidden=True)
    close(th, jh)
    close(tl, jl)
    # paged: one row's prompt into a pool through its page table
    table = page_tables()[:1]
    jpool = jt.init_paged_cache(NP, PAGE)
    tpool = tt.init_paged_cache(NP, PAGE)
    p0 = np.arange(S)[None].astype(np.int32)
    jl, _, jh = jt.decode_step(jtp, jnp.asarray(toks[:1]), jnp.asarray(p0),
                               jpool, page_table=jnp.asarray(table),
                               return_hidden=True)
    tl, _, th = tt.decode_step(ttp, tensor(toks[:1], torch.long),
                               tensor(p0, torch.long), tpool,
                               page_table=tensor(table, torch.long),
                               return_hidden=True)
    close(th, jh)
    with jcapture() as jbox:
        jl, _ = jt.logits(jtp, jnp.asarray(toks))
    with capture_hidden() as box:
        tl = tt.logits(ttp, tensor(toks, torch.long))
    close(box["hidden"], jbox["hidden"])
    close(tl, jl)
    with capture_hidden() as outer:
        with capture_hidden() as inner:
            tt.hidden(ttp, tensor(toks, torch.long))
    assert "hidden" in inner and "hidden" not in outer     # innermost only
    tt.hidden(ttp, tensor(toks, torch.long))               # no open scope


# ---------------------------------------------------------------- drafting

@pytest.mark.parametrize("kind", KINDS)
def test_head_draft_chain_matches_reference(target, heads, kind):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    rng = np.random.default_rng(6)
    h_feat = rng.standard_normal((B, D)).astype(np.float32)
    pending = rng.integers(0, V, B).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), G + 2)
    jx, jp = jdrafter.head_draft_chain(
        jh, jhp, jtp, JCFG, jspec.SDConfig(gamma=G, temperature=0.7),
        jnp.asarray(h_feat), jnp.asarray(pending), list(keys[:G]))
    noise = {"draft": tensor(jnp.stack([gumbel(keys[j], (B, V))
                                        for j in range(G)]))}
    tx, tp = tdrafter.head_draft_chain(
        th, thp, ttp, tt.cfg, tspec.SDConfig(gamma=G, temperature=0.7),
        tensor(h_feat), tensor(pending, torch.long), noise=noise)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    close(tp, jp)
    assert not tp[G].any()                                 # bonus slot


@pytest.mark.parametrize("kind", KINDS)
def test_head_draft_tree_matches_reference(target, heads, kind):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    rng = np.random.default_rng(8)
    h_feat = rng.standard_normal((B, D)).astype(np.float32)
    pending = rng.integers(0, V, B).astype(np.int32)
    jts, tts = JTreeSpec(SPEC), TTreeSpec(SPEC)
    keys = jax.random.split(jax.random.PRNGKey(9), jts.depth)
    jtok, jp = jdrafter.head_draft_tree(
        jh, jhp, jtp, JCFG, jspec.SDConfig(temperature=0.7), jts,
        jnp.asarray(h_feat), jnp.asarray(pending), list(keys))
    noise = {"draft": [tensor(gumbel(keys[d], (B, jts.level_sizes[d],
                                               jts.branching[d], V)))
                       for d in range(jts.depth)]}
    ttok, tp = tdrafter.head_draft_tree(
        th, thp, ttp, tt.cfg, tspec.SDConfig(temperature=0.7), tts,
        tensor(h_feat), tensor(pending, torch.long), noise=noise)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    close(tp, jp)


# ---------------------------------------------------------------- rounds

ROUNDS = [(k, r) for k in KINDS for r in ("chain", "tree")]


def run_rounds(kind, how, heads, target, jst, tst, key):
    """One round of each package from the given states, the port fed the
    reference's draws from ``key``."""
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    jsdc = jspec.SDConfig(gamma=G, temperature=0.7)
    tsdc = tspec.SDConfig(gamma=G, temperature=0.7)
    if how == "chain":
        jnew, jn = jspec.sd_round(jh, jt, jsdc, jhp, jtp, jst, key)
        tnew, tn = tspec.sd_round(th, tt, tsdc, thp, ttp, tst, None,
                                  chain_noise(key, G, V))
    else:
        jts = JTreeSpec(SPEC)
        jnew, jn = jround.tree_round(jh, jt, jsdc, jts, jhp, jtp, jst, key)
        tnew, tn = tround.tree_round(th, tt, tsdc, TTreeSpec(SPEC), thp, ttp,
                                     tst, None, tree_noise(key, jts, V))
    assert "d_cache" not in tnew
    for name in ("tokens", "lengths", "pending"):
        assert np.array_equal(tnew[name].numpy(), np.asarray(jnew[name])), name
    close(tnew["h_feat"], jnew["h_feat"])
    return tnew, jnew, tn, jn


@pytest.mark.parametrize("kind,how", ROUNDS)
def test_temp07_head_round_matches_given_reference_noise(target, heads, kind,
                                                         how):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    k0, kr = jax.random.split(jax.random.PRNGKey(11))
    toks = prompt()
    extra = 8
    jst = jspec._prefill_state(jh, jt, jhp, jtp, jnp.asarray(toks), S + extra,
                               jspec.SDConfig(gamma=G, temperature=0.7), k0)
    tst = tspec._prefill_state(th, tt, thp, ttp, tensor(toks, torch.long),
                               S + extra, tspec.SDConfig(gamma=G, temperature=0.7),
                               None, noise=tensor(gumbel(k0, (B, V))))
    assert "d_cache" not in tst and np.array_equal(tst["pending"].numpy(),
                                                   np.asarray(jst["pending"]))
    close(tst["h_feat"], jst["h_feat"])
    tnew, jnew, tn, jn = run_rounds(kind, how, heads, target, jst, tst, kr)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    jc = jnew["t_cache"]["groups"][0]
    for i, layer in enumerate(tnew["t_cache"]):
        assert np.array_equal(layer["pos"].numpy(), np.asarray(jc["pos"][i]))
        close(layer["k"], jc["k"][i])


def paged_head_states(target):
    """Both packages' paged states as torch_paged builds them (rows 0 and 1
    share 2 prefix pages, row 2 inactive mid-prefill), with the target's
    pool only and ``h_feat`` from each row's last fed position."""
    jt, jtp, tt, ttp = target
    table = page_tables()
    rng = np.random.default_rng(4)
    toks = rng.integers(3, V, (3, 12)).astype(np.int32)
    toks[1, :SHARED * PAGE] = toks[0, :SHARED * PAGE]
    jpool, tpool = jt.init_paged_cache(NP, PAGE), tt.init_paged_cache(NP, PAGE)
    h_feat = np.zeros((3, D), np.float32)
    for row, lo, hi in ((0, 0, 12), (1, SHARED * PAGE, 12), (2, 0, 4)):
        pos = np.arange(lo, hi)[None].astype(np.int32)
        _, jpool, jh = jt.decode_step(jtp, jnp.asarray(toks[row:row + 1, lo:hi]),
                                      jnp.asarray(pos), jpool,
                                      page_table=jnp.asarray(table[row:row + 1]),
                                      return_hidden=True)
        _, tpool, th = tt.decode_step(ttp, tensor(toks[row:row + 1, lo:hi],
                                                  torch.long),
                                      tensor(pos, torch.long), tpool,
                                      page_table=tensor(table[row:row + 1],
                                                        torch.long),
                                      return_hidden=True)
        close(th, jh)
        h_feat[row] = np.asarray(jh[0, -1])
    tokens = np.zeros((3, 48), np.int32)
    tokens[:, :12] = toks
    common = dict(tokens=tokens, lengths=np.array(PLEN, np.int32),
                  pending=rng.integers(3, V, 3).astype(np.int32),
                  active=ACTIVE, page_table=table)
    jst = {k: jnp.asarray(v) for k, v in common.items()}
    jst.update(t_cache=jpool, h_feat=jnp.asarray(h_feat))
    tst = {k: tensor(v, None if k == "active" else torch.long)
           for k, v in common.items()}
    tst.update(t_cache=tpool, h_feat=tensor(h_feat))
    return jst, tst


@pytest.mark.parametrize("kind,how", ROUNDS)
def test_temp07_paged_head_round_matches_given_reference_noise(target, heads,
                                                               kind, how):
    jst, tst = paged_head_states(target)
    h_before = tst["h_feat"].clone()
    tnew, jnew, tn, jn = run_rounds(kind, how, heads, target, jst, tst,
                                    jax.random.PRNGKey(21))
    assert np.array_equal(tn.numpy()[ACTIVE], np.asarray(jn)[ACTIVE])
    assert torch.equal(tnew["h_feat"][~tensor(ACTIVE)], h_before[~tensor(ACTIVE)])
    assert torch.equal(tnew["active"], tensor(ACTIVE))
    jc = jnew["t_cache"]["groups"][0]
    for i, layer in enumerate(tnew["t_cache"]):
        check_pool(layer, {n: a[i] for n, a in jc.items()})


@pytest.mark.parametrize("kind", KINDS)
def test_temp0_head_tokens_equal_reference_greedy(target, heads, kind):
    """Greedy chain and tree speculation with heads give the reference's
    tokens, which are the target's greedy tokens."""
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    toks, new = prompt(seed=12, n=2, s=8), 12
    jar, _ = jspec.autoregressive_generate(jt, jtp, jnp.asarray(toks), new,
                                           temperature=0.0)
    jchain, _ = jspec.speculative_generate(
        jh, jt, jhp, jtp, jnp.asarray(toks), new,
        jspec.SDConfig(gamma=G, temperature=0.0))
    tchain, tstats = tspec.speculative_generate(
        th, tt, thp, ttp, tensor(toks, torch.long), new,
        tspec.SDConfig(gamma=G, temperature=0.0))
    ttree, _ = tround.tree_speculative_generate(
        th, tt, thp, ttp, tensor(toks, torch.long), new,
        tspec.SDConfig(temperature=0.0), TTreeSpec(SPEC))
    want = np.asarray(jar)
    assert np.array_equal(np.asarray(jchain)[:, :8 + new], want)
    assert np.array_equal(tchain[:, :8 + new].numpy(), want)
    assert np.array_equal(ttree[:, :8 + new].numpy(), want)
    assert tstats.tau >= 1.0


# ---------------------------------------------------------------- engine

def test_continuous_engine_with_heads(target, heads):
    """No drafter pool, ``h_feat`` per slot; at temperature 0 the engine
    gives the static generation's tokens (chain and tree, both kinds, 3
    requests through 2 slots)."""
    _, _, tt, ttp = target
    rng = np.random.default_rng(0)
    lens, news = (12, 9, 14), (10, 7, 9)
    prompts = [rng.integers(3, V, n).astype(np.int64) for n in lens]
    for kind in KINDS:
        th, thp = heads[kind][2:]
        for spec in (None, TTreeSpec(SPEC)):
            engine = ContinuousEngine(
                target=tt, target_params=ttp, draft_heads=th,
                draft_head_params=thp, tree=spec,
                sd=tspec.SDConfig(gamma=G, temperature=0.0), max_batch=2,
                max_seq_len=24, page_size=8, prefill_chunk=8)
            assert "d_cache" not in engine._state
            assert engine._state["h_feat"].shape == (2, D)
            assert len(engine._caches()) == 1
            res = engine.serve([ServeRequest(prompt=p, max_new_tokens=m,
                                             request_id=i)
                                for i, (p, m) in enumerate(zip(prompts, news))])
            for i, r in enumerate(res):
                want, _ = tspec.autoregressive_generate(
                    tt, ttp, torch.as_tensor(prompts[i][None]), news[i],
                    temperature=0.0)
                assert np.array_equal(r.tokens, want[0, lens[i]:].numpy()), \
                    (kind, spec, i)


def test_continuous_engine_refuses_bad_drafters(target, heads):
    _, _, tt, ttp = target
    th, thp = heads["eagle"][2:]
    kw = dict(target=tt, target_params=ttp, max_batch=2, max_seq_len=24)
    with pytest.raises(ValueError, match="not both"):
        ContinuousEngine(draft=tt, draft_params=ttp, draft_heads=th,
                         draft_head_params=thp, **kw)
    with pytest.raises(ValueError, match="speculative-only"):
        ContinuousEngine(**kw)
    medusa, mp = heads["medusa"][2:]
    with pytest.raises(ValueError, match="gamma 5 exceeds"):
        ContinuousEngine(draft_heads=medusa, draft_head_params=mp,
                         sd=tspec.SDConfig(gamma=5), **kw)
    with pytest.raises(ValueError, match="depth 5 exceeds"):
        ContinuousEngine(draft_heads=medusa, draft_head_params=mp,
                         tree=TTreeSpec((1,) * 5), **kw)
    ContinuousEngine(draft_heads=medusa, draft_head_params=mp,
                     sd=tspec.SDConfig(gamma=4), **kw)     # K == 4: fine
    assert is_head_drafter(th) and not is_head_drafter(tt)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("kind", KINDS)
def test_param_count_equals_initialised_params(heads, kind):
    """The count, the shapes, and the dtypes: float32 master weights by
    default; served heads (a dtype given, or through the bridge) hold their
    matmul weights in it and their norms in float32."""
    jh, jhp, th, _ = heads[kind]
    leaves = flat(th.init(0, "cpu"))
    assert sum(p.numel() for p in leaves.values()) == th.hc.param_count() \
        == jh.hc.param_count()
    assert {k: tuple(v.shape) for k, v in leaves.items()} == \
        theads.head_param_shapes(th.hc)
    assert all(v.dtype == torch.float32 for v in leaves.values())
    for served in (th.init(0, "cpu", torch.bfloat16),
                   head_params_from_jax(jax.tree.map(np.asarray, jhp), th.hc,
                                        "cpu", torch.bfloat16)):
        for path, leaf in flat(served).items():
            want = torch.float32 if "norm" in path[-1] else torch.bfloat16
            assert leaf.dtype == want, path


# ---------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("kind", KINDS)
def test_reference_head_checkpoint_loads_into_port(tmp_path, target, heads,
                                                   kind):
    jt, jtp, tt, ttp = target
    jh, jhp, th, thp = heads[kind]
    path = str(tmp_path / "ref_heads.npz")
    jsave_heads(path, jh, jhp)
    loaded = load_draft_heads(path, th, "cpu")
    h = np.random.default_rng(1).standard_normal((2, D)).astype(np.float32)
    if kind == "medusa":
        close(theads.medusa_logits(loaded, ttp, tt.cfg, th.hc, tensor(h)),
              jheads.medusa_logits(jhp, jtp, JCFG, jh.hc, jnp.asarray(h)))
    else:
        close(theads.eagle_logits(loaded, ttp, tt.cfg, th.hc,
                                  tensor(h)[:, None]),
              jheads.eagle_logits(jhp, jtp, JCFG, jh.hc, jnp.asarray(h)[:, None]))
    # and the port's file loads into the reference, leaf for leaf
    path2 = str(tmp_path / "port_heads.npz")
    save_draft_heads(path2, th, loaded)
    back = jload_heads(path2, jh)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jhp)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_head_checkpoint_config_mismatch_raises(tmp_path, heads):
    jh, jhp, th, thp = heads["eagle"]
    path = str(tmp_path / "heads.npz")
    save_draft_heads(path, th, thp)
    other = HeadDrafter(dataclasses.replace(th.hc, num_heads=2))
    with pytest.raises(ValueError, match="mismatch"):
        load_draft_heads(path, other, "cpu")
    with pytest.raises(ValueError, match="mismatch"):
        load_draft_heads(path, heads["medusa"][2], "cpu")
    wide = HeadConfig.for_target("eagle", port_config(JCFG).replace(d_model=32))
    with pytest.raises(ValueError, match="shapes"):
        head_params_from_jax(jax.tree.map(np.asarray, jhp), wide, "cpu")

"""The port's paged KV pool against the reference: ``paged_decode_attention``
(T = 1, gamma+1 and a tree mask; fp and int8 pools; shared pages, null-page
table entries and an inactive row) and the pool utilities
(``trim_paged_cache``, ``commit_tree_path_paged``, ``invalidate_pages``,
``copy_pages``, ``apply_page_permutation``); then the null page's guard:
NaN/Inf written into physical page 0 must leave a round's active rows
unchanged. Paged rounds against the reference: test_torch_paged_rounds.py.

Both packages get the same float32 weights (``torch_parity.PAIRS``) and the
same pools. Tolerance ``TOL`` (1e-5) for tensors, float32 on both sides;
positions, tokens and counts must be equal. Physical page 0 is left out of
the pool comparisons (``torch_paged``). Outputs of inactive rows are
discarded by contract and checked only for finiteness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import speculative as jspec
from repro.models import attention as jattn
from repro.serving import kv_pool as jkvp
from repro.spectree import round as jround
from repro.spectree.tree import TreeSpec as JTreeSpec
from repro.spectree.tree import tree_attn_mask as jtree_mask
from repro_torch.core import speculative as tspec
from repro_torch.models import attention as tattn
from repro_torch.serving import kv_pool as tkvp
from repro_torch.spectree import round as tround
from repro_torch.spectree.tree import TreeSpec as TTreeSpec
from torch_paged import (ACTIVE, MAXP, NP, PAGE, PLEN, SHARED, chain_noise,
                         check_pool, jpool, page_tables, prefill_states,
                         random_pool, tpool, tree_noise)
from torch_parity import TOL, models, one_torch_thread, tensor  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# ------------------------------------------------------------ attention

CASES = {"T1": 1, "chain": 4, "tree": 7}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_attention_matches_reference(models, case, kv_quant):
    jt, jtp = models["j"][:2]
    tt, ttp = models["t"][:2]
    cfg = jt.cfg
    rng = np.random.default_rng(7)
    table = page_tables()
    table[2] = 0                                     # inactive: masked row
    lengths = np.array(PLEN)
    leaves = random_pool(rng, cfg.num_kv_heads, cfg.head_dim_, kv_quant,
                         table, lengths)
    T = CASES[case]
    x = rng.standard_normal((3, T, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if case == "tree":
        spec = JTreeSpec((2, 2))
        pos = lengths[:, None] + np.asarray(spec.depths())[None]
        slots = lengths[:, None] + np.arange(T)[None]
        mask = np.asarray(jtree_mask(spec, 0, T, jnp.asarray(lengths),
                                     MAXP * PAGE))
        kw_j = {"slots": jnp.asarray(slots, jnp.int32),
                "attn_mask": jnp.asarray(mask)}
        kw_t = {"slots": tensor(slots, torch.long), "attn_mask": tensor(mask)}
    else:
        pos = lengths[:, None] + np.arange(T)[None]
    jp = jax.tree.map(lambda a: a[0], jtp["groups"][0]["attn"])
    jout, jnew = jattn.paged_decode_attention(
        jp, jnp.asarray(x), jpool(leaves)["rem"][0], jnp.asarray(table),
        jnp.asarray(pos, jnp.int32), cfg, **kw_j)
    tout, tnew = tattn.paged_decode_attention(
        ttp["layers"][0]["attn"], tensor(x), tpool(leaves)[0], tensor(table),
        tensor(pos, torch.long), tt.cfg, **kw_t)
    np.testing.assert_allclose(tout.numpy()[ACTIVE], np.asarray(jout)[ACTIVE],
                               atol=TOL, rtol=0)
    assert np.isfinite(tout.numpy()).all()
    check_pool(tnew, jnew)
    # the null page is zeroed after the write, so no view ever reads junk
    assert not tnew["k"][0].any() and not tnew["v"][0].any()


# ------------------------------------------------------------ pool utilities

@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_pool_utilities_match_reference(kv_quant):
    """trim_paged_cache, invalidate_pages, copy_pages and
    apply_page_permutation on the same pool."""
    rng = np.random.default_rng(8)
    table = page_tables()
    leaves = random_pool(rng, 2, 16, kv_quant, table, (30, 26, 9))
    mpt = np.where(ACTIVE[:, None], table, 0)
    limit = np.array([17, 13, 2], np.int32)
    jc = jspec.trim_paged_cache(jpool(leaves), jnp.asarray(mpt),
                                jnp.asarray(limit))
    tc = tspec.trim_paged_cache(tpool(leaves), tensor(mpt, torch.long),
                                tensor(limit, torch.long))
    check_pool(tc[0], jc["rem"][0], skip_null=False)
    # the shared pages hold positions 0..7, below both sharers' limits
    assert (tc[0]["page_pos"][table[0, :SHARED]] >= 0).all()

    freed = [5, 9, 30]
    jc = jkvp.invalidate_pages(jc, freed)
    tc = tkvp.invalidate_pages(tc, freed)
    check_pool(tc[0], jc["rem"][0], skip_null=False)

    src, dst = [1, 2, 7], [31, 32, 33]
    jc = jkvp.copy_pages(jc, src, dst)
    tc = tkvp.copy_pages(tc, src, dst)
    check_pool(tc[0], jc["rem"][0], skip_null=False)

    perm = np.concatenate([[0], rng.permutation(np.arange(1, NP))]).astype(np.int32)
    jc = jkvp.apply_page_permutation(jc, perm)
    tc = tkvp.apply_page_permutation(tc, perm)
    check_pool(tc[0], jc["rem"][0], skip_null=False)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_commit_tree_path_paged_matches_reference(kv_quant):
    """Root-path commit over shared pages and an inactive row; the sources
    are gathered before the destinations are written (path nodes past the
    committed depth read slots that the commit overwrites)."""
    rng = np.random.default_rng(9)
    table = page_tables()
    lengths = np.array([13, 10, 4])
    leaves = random_pool(rng, 2, 16, kv_quant, table, lengths + 7)
    mpt = np.where(ACTIVE[:, None], table, 0)
    path = np.array([[0, 2, 5], [0, 1, 4], [0, 2, 6]], np.int32)
    n_acc = np.array([2, 1, 2], np.int32)
    jc = jround.commit_tree_path_paged(jpool(leaves), jnp.asarray(mpt),
                                       jnp.asarray(lengths, jnp.int32),
                                       jnp.asarray(path), jnp.asarray(n_acc), 7)
    tc = tround.commit_tree_path_paged(tpool(leaves), tensor(mpt, torch.long),
                                       tensor(lengths, torch.long),
                                       tensor(path, torch.long),
                                       tensor(n_acc, torch.long), 7)
    check_pool(tc[0], jc["rem"][0])


# ------------------------------------------------------------ null page

def _poison_null_page(state):
    for name in ("t_cache", "d_cache"):
        for layer in state[name]:
            for leaf in ("k", "v", "k_scale", "v_scale"):
                if leaf in layer and layer[leaf].is_floating_point():
                    layer[leaf][0] = float("nan")
                    layer[leaf][0, 0] = float("inf")


def _clone(state):
    return {k: ([{n: a.clone() for n, a in c.items()} for c in v]
                if isinstance(v, list) else v.clone())
            for k, v in state.items()}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_nonfinite_null_page_leaves_active_rows_unchanged(models, kind,
                                                          kv_quant):
    """NaN/Inf written into physical page 0 (the null page every row's
    view reads at probability 0) must not reach the active rows: a round on
    the poisoned pools gives exactly the outputs of a clean pool."""
    tt, ttp, td, tdp = models["t"]
    _, clean = prefill_states(models, kv_quant, reference=False)
    poisoned = _clone(clean)
    _poison_null_page(poisoned)
    V = tt.cfg.vocab_size
    sdc = tspec.SDConfig(gamma=3, temperature=0.7)
    if kind == "chain":
        noise = chain_noise(jax.random.PRNGKey(23), 3, V)

        def run(st):
            dr = tspec.sd_draft_phase(td, sdc, tdp, st, None, noise)
            ver = tspec.sd_verify_phase(tt, sdc, ttp, st, dr)
            new, n = tspec.sd_commit_phase(sdc, st, dr, ver, None, noise)
            return dr["p_stack"], ver["q_stack"], new, n
    else:
        jts, tts = JTreeSpec((2, 2)), TTreeSpec((2, 2))
        noise = tree_noise(jax.random.PRNGKey(23), jts, V)

        def run(st):
            dr = tround.tree_draft_phase(td, sdc, tts, tdp, st, None, noise)
            ver = tround.tree_verify_phase(tt, sdc, tts, ttp, st, dr)
            new, n = tround.tree_commit_phase(sdc, tts, st, dr, ver, None,
                                              noise)
            return dr["p_node"], ver["q_node"], new, n

    p0, q0, new0, n0 = run(clean)
    p1, q1, new1, n1 = run(poisoned)
    assert torch.isfinite(p1[:, ACTIVE]).all() and torch.isfinite(q1[:, ACTIVE]).all()
    assert torch.equal(p1[:, ACTIVE], p0[:, ACTIVE])
    assert torch.equal(q1[:, ACTIVE], q0[:, ACTIVE])
    assert torch.equal(n1[ACTIVE], n0[ACTIVE])
    for name in ("tokens", "lengths", "pending"):
        assert torch.equal(new1[name], new0[name]), name
    for name in ("t_cache", "d_cache"):
        for a, b in zip(new1[name], new0[name]):
            for leaf in a:
                assert torch.equal(a[leaf][1:], b[leaf][1:]), (name, leaf)

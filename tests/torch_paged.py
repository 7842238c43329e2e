"""Shared set-up of the paged-pool parity tests (test_torch_paged.py,
test_torch_paged_rounds.py): three rows over one pool, two of them sharing
prefix pages and the third inactive, the same pools and states on both
sides, and the comparisons, which leave out physical page 0 (the null page:
the reference keeps what was written there, the port zeroes it; its
contents are never read)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.serving import kv_pool as jkvp
from torch_parity import TOL, gumbel, tensor

PAGE, MAXP = 4, 12                 # view width W = 48 slots per row
NP = 1 + 3 * MAXP                  # pool pages, page 0 the null page
PLEN = (12, 12, 4)                 # committed lengths of the three rows
ACTIVE = np.array([True, True, False])
SHARED = 2                         # rows 0 and 1 share their first 2 pages
POOL_NAMES = ("k", "v", "page_pos", "k_scale", "v_scale")


def page_tables():
    """Rows 0 and 1 share a 2-page prompt prefix (the prefix cache's
    mapping); row 2 holds pages but is inactive (mid-prefill). Entries past
    each row's 10 pages are 0 (the null page)."""
    pool = jkvp.PagedKVPool(NP, PAGE, MAXP)
    a = pool.alloc(0, 40)
    pool.alloc(1, 40, shared=a[:SHARED])
    pool.alloc(2, 40)
    return np.stack([pool.table_row(i) for i in range(3)]).astype(np.int32)


def random_pool(rng, Hkv, hd, kv_quant, table, lengths):
    """One layer's pool as numpy leaves: random K/V (and scales) on every
    page, page 0 included; page_pos holds the positions each row's table
    maps below its length, -1 elsewhere, junk on page 0."""
    if kv_quant:
        leaves = {n: rng.integers(-127, 128, (NP, PAGE, Hkv, hd)).astype(np.int8)
                  for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            leaves[n] = rng.uniform(0.001, 0.02, (NP, PAGE, Hkv)).astype(np.float32)
    else:
        leaves = {n: rng.standard_normal((NP, PAGE, Hkv, hd)).astype(np.float32)
                  for n in ("k", "v")}
    pos = np.full((NP, PAGE), -1, np.int32)
    pos[0] = rng.integers(0, 40, PAGE)
    for r, L in enumerate(lengths):
        for s in range(L):
            pos[table[r, s // PAGE], s % PAGE] = s
    leaves["page_pos"] = pos
    return leaves


def jpool(leaves):
    """One layer's pool as a reference cache pytree (pages on axis 0)."""
    return {"groups": (), "rem": ({n: jnp.asarray(a) for n, a in leaves.items()},)}


def tpool(leaves):
    return [{n: tensor(a) for n, a in leaves.items()}]


def check_pool(tlayer, jlayer, skip_null=True):
    """Pool leaves equal on every page but the null page: positions exactly,
    int8 values exactly, float values within TOL."""
    lo = 1 if skip_null else 0
    for name in POOL_NAMES:
        if name not in jlayer:
            assert name not in tlayer
            continue
        got, want = tlayer[name].numpy()[lo:], np.asarray(jlayer[name])[lo:]
        if got.dtype in (np.int32, np.int8):
            assert np.array_equal(got, want), name
        else:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)


def prefill_states(models, kv_quant, reference=True):
    """Both packages' paged round states after feeding each row's prompt
    through the paged decode path: rows 0 and 1 share the first 2 pages
    (row 1 feeds only its own tail), row 2 is inactive mid-prefill. With
    ``reference`` False only the port's state is built (the reference's
    state is then None)."""
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    V = jt.cfg.vocab_size
    rng = np.random.default_rng(4)
    table = page_tables()
    prompts = rng.integers(3, V, (3, 12)).astype(np.int32)
    prompts[1, :SHARED * PAGE] = prompts[0, :SHARED * PAGE]
    jst = ({"t_cache": jt.init_paged_cache(NP, PAGE, kv_quant=kv_quant),
            "d_cache": jd.init_paged_cache(NP, PAGE, kv_quant=kv_quant)}
           if reference else None)
    tst = {"t_cache": tt.init_paged_cache(NP, PAGE, kv_quant=kv_quant),
           "d_cache": td.init_paged_cache(NP, PAGE, kv_quant=kv_quant)}
    for row, lo, hi in ((0, 0, 12), (1, SHARED * PAGE, 12), (2, 0, 4)):
        toks, pos = prompts[row:row + 1, lo:hi], np.arange(lo, hi)[None]
        for name, jm, jp, tm, tp in (("t_cache", jt, jtp, tt, ttp),
                                     ("d_cache", jd, jdp, td, tdp)):
            if reference:
                _, jst[name] = jm.decode_step(jp, jnp.asarray(toks),
                                              jnp.asarray(pos, jnp.int32),
                                              jst[name],
                                              page_table=jnp.asarray(
                                                  table[row:row + 1]))
            _, tst[name] = tm.decode_step(tp, tensor(toks, torch.long),
                                          tensor(pos, torch.long), tst[name],
                                          page_table=tensor(table[row:row + 1],
                                                            torch.long))
    tokens = np.zeros((3, 48), np.int32)
    tokens[:, :12] = prompts
    pending = rng.integers(3, V, 3).astype(np.int32)
    lengths = np.array(PLEN, np.int32)
    if reference:
        jst.update(tokens=jnp.asarray(tokens), lengths=jnp.asarray(lengths),
                   pending=jnp.asarray(pending), active=jnp.asarray(ACTIVE),
                   page_table=jnp.asarray(table))
    tst.update(tokens=tensor(tokens, torch.long),
               lengths=tensor(lengths, torch.long),
               pending=tensor(pending, torch.long), active=tensor(ACTIVE),
               page_table=tensor(table, torch.long))
    if reference:
        check_caches(tst, jst)
    return jst, tst


def check_caches(tst, jst):
    for name in ("t_cache", "d_cache"):
        jc = jst[name]["groups"][0]
        for i, layer in enumerate(tst[name]):
            check_pool(layer, {n: a[i] for n, a in jc.items()})


def check_round(tnew, jnew, tn, jn):
    """Active rows' accept counts; every row's tokens, lengths and pending
    (inactive rows frozen); both pools off the null page."""
    assert np.array_equal(tn.numpy()[ACTIVE], np.asarray(jn)[ACTIVE])
    for name in ("tokens", "lengths", "pending"):
        assert np.array_equal(tnew[name].numpy(), np.asarray(jnew[name])), name
    assert np.array_equal(tnew["active"].numpy(), ACTIVE)
    check_caches(tnew, jnew)


def chain_noise(kr, g, V, rows=3):
    """The draws the reference's chain round makes from its key ``kr``."""
    keys = jax.random.split(kr, g + 2)
    return {"draft": tensor(jnp.stack([gumbel(keys[j], (rows, V))
                                       for j in range(g)])),
            "u": tensor(jax.random.uniform(keys[g], (g, rows))),
            "residual": tensor(gumbel(keys[g + 1], (rows, V)))}


def tree_noise(kr, jts, V, rows=3):
    """The draws the reference's tree round makes from its key ``kr``."""
    D, branching = jts.depth, jts.branching
    keys = jax.random.split(kr, 2 * D + sum(branching) + 1)
    rest = iter(keys[D:])
    u, stop = [], []
    for d in range(D):
        u.append(tensor(jnp.stack([jax.random.uniform(next(rest), (rows,))
                                   for _ in range(branching[d])])))
        stop.append(tensor(gumbel(next(rest), (rows, V))))
    return {"draft": [tensor(gumbel(keys[d], (rows, jts.level_sizes[d],
                                              branching[d], V)))
                      for d in range(D)],
            "u": u, "stop": stop,
            "bonus": tensor(gumbel(next(rest), (rows, V)))}

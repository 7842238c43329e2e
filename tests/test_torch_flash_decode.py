"""The port's flash decode (plain version, wrapper and split plan) against
the reference's oracle and its Pallas kernel in interpret mode, and against
the port's own decode attention.

Inputs are drawn with numpy from a seed and fed to both packages. Both
compute fp32 scores from the same values, so they differ only in the order
of the sums: tolerance 1e-5 in float32, and also for bf16 inputs, which
both sides widen to float32 before any arithmetic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_decode as fk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.layers import dense_param

TOL = 1e-5


def _inputs(seed, B, Hkv, G, hd, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0] = False                        # a fully masked row: averages V
    return q, k, v, mask


def _port(q, k, v, mask, softcap=None, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return tref.ref_flash_decode(*t, torch.from_numpy(mask), softcap).numpy()


# every hd in {16, 32, 64, 128} with every G in {1, 2, 3}, and G 8 (Yi-9B,
# Chameleon-34B) at hd 128 and 64, at S the Pallas kernel accepts
# (S % min(128, S) == 0)
SWEEP = [(hd, G, S) for hd, S in ((16, 64), (32, 256), (64, 128), (128, 384))
         for G in (1, 2, 3)] + [(128, 8, 384), (64, 8, 128)]


@pytest.mark.parametrize("hd,G,S", SWEEP)
def test_plain_version_matches_oracle_and_pallas_kernel(hd, G, S):
    q, k, v, mask = _inputs(hd + G + S, 2, 2, G, hd, S)
    got = _port(q, k, v, mask)
    want = np.asarray(jref.ref_flash_decode(q, k, v, mask))
    kern = np.asarray(jops.flash_decode_attention(q, k, v, mask))
    assert got.shape == (2, 2, G, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    # the fully masked row averages V over every slot, as the reference does
    np.testing.assert_allclose(got[0], np.broadcast_to(
        v[0].mean(0)[:, None, :], got[0].shape), atol=TOL, rtol=0)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_bf16_with_softcap(G):
    q, k, v, mask = _inputs(5 + G, 1, 2, G, 64, 256)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = _port(q, k, v, mask, softcap=20.0, dtype=torch.bfloat16)
    want = np.asarray(jref.ref_flash_decode(*jb, mask, softcap=20.0))
    kern = np.asarray(jops.flash_decode_attention(*jb, mask, softcap=20.0))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)


def test_plain_version_ragged_cache_width():
    # S = prompt + max_new + gamma + 2 of a chain run: no multiple of 128
    # (the Pallas kernel needs one; the oracle does not)
    q, k, v, mask = _inputs(7, 2, 4, 1, 128, 197)
    np.testing.assert_allclose(
        _port(q, k, v, mask), np.asarray(jref.ref_flash_decode(q, k, v, mask)),
        atol=TOL, rtol=0)


def test_decode_attention_equals_flash_decode_and_output_projection():
    """The port's decode attention against the kernel route on the same
    q/k/v after insertion: ``_project_qkv``, the new entry written into the
    cache, the validity mask, ``ops.flash_decode_attention`` and ``wo``
    (the counterpart of the reference's test_kernels.py)."""
    cfg = ModelConfig(name="x", arch_type="dense", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=32,
                      head_dim=64, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = {n: dense_param(gen, i, o, torch.float32, "cpu")
              for n, i, o in (("wq", 64, 256), ("wk", 64, 128),
                              ("wv", 64, 128), ("wo", 256, 64))}
    rng = np.random.default_rng(0)
    B, S, P = 2, 128, 100
    kc = torch.from_numpy(rng.standard_normal((B, S, 2, 64)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, S, 2, 64)).astype(np.float32))
    cpos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    cpos = torch.where(cpos < P, cpos, -1)
    x = torch.from_numpy(rng.standard_normal((B, 1, 64)).astype(np.float32))
    pos = torch.full((B, 1), P, dtype=torch.long)
    cache = {"k": kc.clone(), "v": vc.clone(), "pos": cpos.clone()}
    out_ref, _ = tattn.decode_attention(params, x, cache, pos, cfg)

    q, k, v = tattn._project_qkv(params, x, cfg, pos)
    kc[:, P], vc[:, P], cpos[:, P] = k[:, 0], v[:, 0], P
    mask = (cpos >= 0) & (cpos <= P)
    qg = q.reshape(B, 2, 2, 64)                    # (B, Hkv, G, hd), kv-major
    ops.reset_launches()
    att = ops.flash_decode_attention(qg, kc, vc, mask)
    assert ops.LAUNCHES["flash_decode"] == 0       # CPU: the plain version
    out_k = att.reshape(B, 1, 256) @ params["wo"]
    torch.testing.assert_close(out_k, out_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(cache["k"], kc, atol=0, rtol=0)


def test_one_node_tree_equals_flash_decode():
    """With one tree node, tree attention is flash decode with an extra
    axis (the counterpart of the reference's test_spectree.py)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(11, 2, 2, 4, 64, 128))
    mask = torch.arange(128)[None] < torch.tensor([64, 128])[:, None]
    got = ops.tree_verify_attention(q[:, :, None], k, v, mask[:, None, :])
    want = ops.flash_decode_attention(q, k, v, mask)
    torch.testing.assert_close(got[:, :, 0], want, atol=2e-5, rtol=0)


def test_wrapper_sends_cpu_tensors_to_plain_version_uncounted():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 2, 32, 96))
    ops.reset_launches()
    out = ops.flash_decode_attention(q, k, v, mask, softcap=20.0)
    assert "flash_decode" in ops.LAUNCHES
    assert all(n == 0 for n in ops.LAUNCHES.values())
    assert torch.equal(out, tref.ref_flash_decode(q, k, v, mask, 20.0))


@pytest.mark.parametrize("case", ["cpu", "hd48", "dtype", "mask", "layout",
                                  "q_rank", "empty_cache"])
def test_kernel_wrapper_rejects_what_it_cannot_launch(case):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 1, 64, 40))
    if case == "hd48":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif case == "dtype":
        q = q.double()
    elif case == "mask":
        mask = mask.to(torch.uint8)
    elif case == "layout":
        k = k.transpose(0, 1).contiguous()
    elif case == "q_rank":
        q = q[:, :, None]
    elif case == "empty_cache":
        k, v, mask = k[:, :0], v[:, :0], mask[:, :0]
    # every case fails the checks before any build or launch: the kernel
    # computes nothing on the CPU and never quietly takes other inputs
    with pytest.raises(ValueError):
        fk.flash_decode(q, k, v, mask)


# clusters of s blocks the card holds at once: the counts an H100 gave for
# the instances at hd 128 and G 8, one block an SM (chip_smoke.py phase 12
# prints them), and a card of 132 SMs at two blocks an SM without any
# placement loss
H100_HD128 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
CLUSTER_MODELS = {"h100-hd128": H100_HD128.__getitem__,
                  "two-an-sm": lambda s: 264 // s}


@pytest.mark.parametrize("model", list(CLUSTER_MODELS))
@pytest.mark.parametrize("B,Hkv,G,hd,S,itemsize", [
    (4, 32, 1, 128, 197, 2), (4, 8, 1, 128, 1024, 2), (4, 32, 1, 128, 4096, 2),
    (4, 4, 2, 128, 1024, 4), (2, 2, 3, 32, 1, 2), (1, 1, 5, 16, 7, 4),
    (4, 2, 2, 16, 300, 2), (4, 2, 3, 256, 4096, 4), (1, 1, 1, 128, 40000, 2),
    (4, 4, 8, 128, 1024, 2), (4, 4, 8, 128, 16384, 2), (4, 4, 8, 128, 16381, 4),
    (4, 8, 3, 128, 4096, 2), (4, 8, 8, 128, 1024, 2), (2, 3, 17, 64, 201, 2),
    (2, 2, 16, 256, 100, 4), (4, 8, 2, 256, 8192, 2)])
def test_split_plan_covers_every_slot_once(B, Hkv, G, hd, S, itemsize, model):
    """The split plan tiles [0, S) in whole warp chunks, every slot once and
    no split empty, with every split of a (batch, kv head) inside one
    cluster of at most MAX_SPLITS; G <= 16 is one row tile. The splits are
    the most that keep one block an SM and every cluster resident at once:
    one more would break either, or leave a warp without a chunk."""
    clusters = CLUSTER_MODELS[model]
    chunk, splits = fk.plan(B, Hkv, G, hd, S, itemsize, 132, clusters)
    cs = fk.chunk_slots(hd, itemsize)
    step = fk.warps(hd, itemsize) * cs       # one chunk for every warp
    assert chunk % cs == 0 and chunk >= min(step, -(-S // cs) * cs)
    assert splits == -(-S // chunk) and (splits - 1) * chunk < S
    assert 1 <= splits <= fk.MAX_SPLITS
    tiles = fk.row_tiles(G)
    assert tiles == (1 if G <= fk.ROW_TILE else -(-G // fk.ROW_TILE))
    assert fk.rows_per_block(G) == min(G, fk.ROW_TILE)
    pairs = B * Hkv * tiles
    fits = lambda s: pairs * s <= 132 and pairs <= clusters(s)  # noqa: E731
    assert splits == 1 or fits(splits)
    more = splits + 1          # would break the cluster size, a limit of
    assert (more > fk.MAX_SPLITS or not fits(more)     # the card, or leave
            or more > S // step)                       # a warp without a chunk


@pytest.mark.parametrize("arch", list(ARCHS))
def test_registry_decode_shapes_take_one_row_tile(arch):
    """At every G of the registry (1, 2, 3, 6, 8) a (batch, kv head) is one
    row tile, bf16 takes the tensor cores; head dims the kernel lacks
    (zamba2's 112, xlstm's 512) are refused before any launch."""
    cfg = ARCHS[arch]
    G, hd = cfg.q_per_kv, cfg.head_dim_
    if hd not in fk.HEAD_DIMS:
        q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 1, 1, G, hd, 8))
        with pytest.raises(ValueError, match="head dim"):
            fk.flash_decode(q, k, v, mask)
        return
    assert fk.row_tiles(G) == 1 and fk.rows_per_block(G) == G
    assert fk.route(hd, torch.bfloat16) == "mma"
    assert fk.route(hd, torch.float32) == "simt"
    for S in (1024, 16384):
        chunk, splits = fk.plan(4, cfg.num_kv_heads, G, hd, S, 2, 132,
                                lambda s: 264 // s)
        assert splits <= fk.MAX_SPLITS and (splits - 1) * chunk < S <= splits * chunk

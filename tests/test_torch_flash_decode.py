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


# every hd in {16, 32, 64, 128} with every G in {1, 2, 3}, at S the Pallas
# kernel accepts (S % min(128, S) == 0)
SWEEP = [(hd, G, S) for hd, S in ((16, 64), (32, 256), (64, 128), (128, 384))
         for G in (1, 2, 3)]


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
                                  "q_rank"])
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
    # every case fails the checks before any build or launch: the kernel
    # computes nothing on the CPU and never quietly takes other inputs
    with pytest.raises(ValueError):
        fk.flash_decode(q, k, v, mask)


@pytest.mark.parametrize("B,Hkv,G,hd,S,itemsize", [
    (4, 32, 1, 128, 197, 2), (4, 8, 1, 128, 1024, 2), (4, 32, 1, 128, 4096, 2),
    (4, 4, 2, 128, 1024, 4), (2, 2, 3, 32, 1, 2), (1, 1, 5, 16, 7, 4),
    (4, 2, 2, 16, 300, 2), (4, 2, 3, 256, 4096, 4), (1, 1, 1, 128, 40000, 2)])
def test_split_plan_covers_every_slot_once(B, Hkv, G, hd, S, itemsize):
    """The split plan tiles [0, S) in whole steps of the block's loop, no
    split empty, and gives the grid at least half of BLOCKS_PER_SM blocks
    per SM where S allows (rounding the chunk up to whole steps may drop
    some splits)."""
    chunk, splits = fk.plan(B, Hkv, G, hd, S, itemsize, 132)
    lanes = min(32, hd * itemsize // 16)
    step = fk.THREADS // lanes * fk.UNROLL
    assert chunk % step == 0 and chunk >= step
    assert splits == -(-S // chunk) and (splits - 1) * chunk < S
    blocks = B * Hkv * -(-G // fk.rows_per_block(G)) * splits
    assert splits == 1 or blocks <= fk.BLOCKS_PER_SM * 132 + B * Hkv * G
    if S >= 2 * step * fk.BLOCKS_PER_SM * 132:
        assert 2 * blocks >= fk.BLOCKS_PER_SM * 132

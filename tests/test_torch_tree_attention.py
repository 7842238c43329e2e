"""The port's tree attention (plain version and wrapper) against the
reference's oracle and its Pallas kernel in interpret mode.

Inputs are drawn with numpy from a seed and fed to both packages. Both
compute fp32 scores from the same values, so they differ only in the order
of the sums: tolerance 2e-5 in float32, and also for bf16 inputs, which
both sides widen to float32 before any arithmetic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.tree_attention import tree_attention as pallas_tree_attention
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tree_attention as tk

TOL = 2e-5


def _inputs(seed, B, Hkv, N, G, hd, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, N, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    mask = rng.random((B, N, S)) < 0.6
    mask[0, 0] = False                     # one fully masked row: averages V
    return q, k, v, mask


def _port(q, k, v, mask, softcap=None, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return tref.ref_tree_attention(*t, torch.from_numpy(mask),
                                   softcap).numpy()


# (hd, G, N, S): every hd the kernel takes (16, 32, 64, 128, 256), G in
# {1, 3}, N in {1, 7, 13} and S in {128, 256} appears at least once.
SWEEP = [(16, 1, 1, 128), (16, 3, 13, 256), (32, 3, 7, 128), (64, 1, 7, 256),
         (64, 3, 1, 128), (128, 1, 13, 128), (128, 3, 7, 256), (256, 1, 7, 128)]


@pytest.mark.parametrize("hd,G,N,S", SWEEP)
def test_plain_version_matches_oracle_and_pallas_kernel(hd, G, N, S):
    q, k, v, mask = _inputs(hd + G + N + S, 2, 2, N, G, hd, S)
    got = _port(q, k, v, mask)
    want = np.asarray(jref.ref_tree_attention(q, k, v, mask))
    kern = np.asarray(pallas_tree_attention(q, k, v, mask, interpret=True))
    assert got.shape == (2, 2, N, G, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    # the fully masked row averages V over every slot, as the reference does
    np.testing.assert_allclose(got[0, :, 0], np.broadcast_to(
        v[0].mean(0)[:, None, :], got[0, :, 0].shape), atol=TOL, rtol=0)


def test_plain_version_bf16_with_softcap():
    q, k, v, mask = _inputs(5, 2, 3, 7, 3, 64, 256)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = _port(q, k, v, mask, softcap=30.0, dtype=torch.bfloat16)
    want = np.asarray(jref.ref_tree_attention(*jb, mask, softcap=30.0))
    kern = np.asarray(pallas_tree_attention(*jb, mask, softcap=30.0,
                                            interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)


def test_plain_version_ragged_cache_width():
    # S = prompt + max_new + N + 2 of a tree run: no multiple of 128 (the
    # Pallas kernel needs one; the oracle does not)
    q, k, v, mask = _inputs(7, 2, 4, 7, 1, 128, 201)
    np.testing.assert_allclose(
        _port(q, k, v, mask), np.asarray(jref.ref_tree_attention(q, k, v, mask)),
        atol=TOL, rtol=0)


def test_wrapper_sends_cpu_tensors_to_plain_version_uncounted():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 7, 2, 64, 96))
    ops.reset_launches()
    out = ops.tree_verify_attention(q, k, v, mask, softcap=20.0)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    assert torch.equal(out, tref.ref_tree_attention(q, k, v, mask, 20.0))


@pytest.mark.parametrize("case", ["cpu", "hd48", "dtype", "mask", "layout"])
def test_kernel_wrapper_rejects_what_it_cannot_launch(case):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 3, 1, 64, 40))
    if case == "hd48":                    # a head dim no instance takes
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif case == "dtype":
        q = q.double()
    elif case == "mask":
        mask = mask.to(torch.uint8)
    elif case == "layout":
        k = k.transpose(0, 1).contiguous()
    # every case fails the checks before any build or launch: the kernel
    # computes nothing on the CPU and never quietly takes other inputs
    with pytest.raises(ValueError):
        tk.tree_attention(q, k, v, mask)


def test_kernel_takes_every_head_dim_of_the_reference():
    assert tk.HEAD_DIMS == (16, 32, 64, 128, 256)


@pytest.mark.parametrize("hd,itemsize,symbol,threads", [
    (16, 2, "tree_attention_kernel<__nv_bfloat16, 16, 8>", tk.THREADS),
    (128, 2, "tree_attention_mma<128>", tk.MMA_THREADS),
    (256, 2, "tree_attention_mma_ring<256>", tk.RING_THREADS),
    (256, 4, "tree_attention_kernel<float, 256, 8>", tk.THREADS)])
def test_instance_by_head_dim_and_dtype(hd, itemsize, symbol, threads):
    """bf16 at head dims 32-256 runs a tensor-core instance (at 256 the
    one that stages K and V in rings, 4 warps), fp32 and bf16 at hd 16 the
    CUDA-core kernel; 16 rows a block on the tensor cores."""
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    assert tk.on_tensor_cores(hd, itemsize) == (itemsize == 2 and hd >= 32)
    p = tk.launch_plan(4, 8, 7, 2, hd, 201, dtype, 132)
    assert (p.launches[0].symbol, p.launches[0].threads) == (symbol, threads)
    mma = tk.on_tensor_cores(hd, itemsize)
    assert tk.rows_per_block(14, hd, itemsize) == (16 if mma else 8)
    assert tk.on_tensor_cores(256, 2) and not tk.on_tensor_cores(256, 4)


@pytest.mark.parametrize("B,Hkv,N,G,hd,S,itemsize", [
    (4, 32, 7, 1, 128, 201, 2), (4, 32, 7, 1, 128, 1024, 4), (4, 8, 1, 1, 128, 201, 2),
    (4, 8, 4, 1, 128, 201, 4), (4, 8, 7, 3, 128, 201, 2), (2, 4, 13, 3, 64, 300, 4),
    (4, 2, 7, 2, 16, 201, 2), (4, 2, 7, 3, 32, 197, 4), (2, 4, 7, 2, 256, 512, 4),
    (1, 2, 1, 1, 128, 1, 4), (1, 1, 3, 1, 64, 40000, 2),
    # bf16 at hd 256 (Gemma-2-9B's verify): S 201, the 4,352-slot paged
    # view at B 4 and B 1, and two row tiles (N 13, G 2)
    (4, 8, 7, 2, 256, 201, 2), (4, 8, 7, 2, 256, 4352, 2),
    (1, 8, 7, 2, 256, 4352, 2), (4, 8, 13, 2, 256, 201, 2)])
def test_split_plan_covers_every_slot_once(B, Hkv, N, G, hd, S, itemsize):
    """The split plan tiles [0, S) in whole steps of the block's loop, no
    split empty, and gives the grid at least half of BLOCKS_PER_SM blocks
    per SM where S allows (rounding the chunk up to whole steps may drop
    some splits)."""
    chunk, splits = tk.plan(B, Hkv, N, G, hd, S, itemsize, 132)
    assert tk.plan(4, 32, 7, 1, 128, 201, 2, 132) == (256, 1)   # target verify
    step = tk.step_slots(hd, itemsize)
    mma = tk.on_tensor_cores(hd, itemsize)
    warps = (tk.RING_THREADS if hd > tk.RING_ABOVE else tk.MMA_THREADS) // 32
    assert step == (warps * tk.MMA_CHUNK if mma else
                    tk.THREADS // min(32, hd * itemsize // 16) * tk.UNROLL)
    assert chunk % step == 0 and chunk >= step
    assert splits == -(-S // chunk) and (splits - 1) * chunk < S
    covered = np.zeros(S, dtype=int)
    for z in range(splits):
        covered[z * chunk:min(S, (z + 1) * chunk)] += 1
    assert (covered == 1).all()
    rows = N * G
    rt = tk.rows_per_block(rows, hd, itemsize)
    blocks = B * Hkv * -(-rows // rt) * splits
    assert rt == 16 if mma else rt in (1, 2, 4, 8) and rt >= min(rows, 8)
    bps = tk.BLOCKS_PER_SM[mma]
    assert splits == 1 or blocks <= bps * 132 + B * Hkv * rows
    if S >= 2 * step * bps * 132:
        assert 2 * blocks >= bps * 132

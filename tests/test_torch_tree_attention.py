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


# (hd, G, N, S): every hd in {16, 64, 128}, G in {1, 3}, N in {1, 7, 13}
# and S in {128, 256} appears at least once.
SWEEP = [(16, 1, 1, 128), (16, 3, 13, 256), (64, 1, 7, 256),
         (64, 3, 1, 128), (128, 1, 13, 128), (128, 3, 7, 256)]


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


@pytest.mark.parametrize("case", ["cpu", "hd32", "dtype", "mask", "layout"])
def test_kernel_wrapper_rejects_what_it_cannot_launch(case):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 3, 1, 64, 40))
    if case == "hd32":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
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

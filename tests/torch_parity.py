"""Shared set-up of the parity tests between ``repro`` (JAX, the reference)
and ``repro_torch`` (the PyTorch port): config pairs, the same float32
weights on both sides, and the reference's random draws handed to the
port as noise tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs import llama2_7b_chat as jllama
from repro.core import speculative as jspec
from repro.experiments.pipeline import draft_config, target_config
from repro.models import Model as JModel
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import speculative as tspec
from repro_torch.models.model import Model as TModel

TOL = 1e-5          # float32 on both sides: only the order of sums differs
B, S, MAX_NEW = 2, 12, 16
PAIRS = {   # (target, drafter): hd 32/16 with G 3/2, and the reduced Llama-2
    "pipeline": (target_config(), draft_config()),
    "llama2-reduced": (jcfgs.reduced(jllama.CONFIG),
                       jcfgs.reduced(jllama.DRAFTER)),
}


def port_config(cfg):
    """The port's config with the reference config's values."""
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def tensor(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def gumbel(key, shape):
    """The Gumbel noise ``jax.random.categorical`` draws from ``key``."""
    return jax.random.gumbel(key, shape, jnp.float32)


@pytest.fixture(scope="module", params=sorted(PAIRS))
def models(request):
    """Reference and port (target, drafter) with the same float32 weights,
    plus a prompt: {"j": [jt, jtp, jd, jdp], "t": [tt, ttp, td, tdp]}."""
    out = {"j": [], "t": []}
    for cfg, seed in zip(PAIRS[request.param], (0, 1)):
        jm = JModel(cfg.replace(dtype="float32"))
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        tm = TModel(port_config(jm.cfg), device="cpu")
        out["j"] += [jm, jp]
        out["t"] += [tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                         tm.cfg, "cpu")]
    out["prompt"] = np.random.default_rng(3).integers(
        3, out["j"][0].cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def start_states(models, extra, key, temperature=0.7):
    """Both packages' prefill states from one prompt, with caches of
    S + MAX_NEW + extra slots; the port samples the first pending token
    with the reference's noise."""
    jt, jtp, jd, jdp = models["j"]
    tt, ttp, td, tdp = models["t"]
    prompt = models["prompt"]
    jsdc = jspec.SDConfig(gamma=3, temperature=temperature)
    tsdc = tspec.SDConfig(gamma=3, temperature=temperature)
    max_total = S + MAX_NEW + extra
    jstate = jspec._prefill_state(jd, jt, jdp, jtp, jnp.asarray(prompt),
                                  max_total, jsdc, key)
    V = jt.cfg.vocab_size
    tstate = tspec._prefill_state(td, tt, tdp, ttp, tensor(prompt, torch.long),
                                  max_total, tsdc, None,
                                  noise=tensor(gumbel(key, (B, V))))
    assert np.array_equal(tstate["pending"].numpy(),
                          np.asarray(jstate["pending"]))
    return jsdc, tsdc, jstate, tstate


def check_state(tnew, jnew, tn, jn):
    """A round's outputs equal: n_acc, tokens, lengths, pending, and both
    caches (positions exactly, K within TOL)."""
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    for name in ("tokens", "lengths", "pending"):
        assert np.array_equal(tnew[name].numpy(), np.asarray(jnew[name])), name
    for cname in ("t_cache", "d_cache"):
        jc = jnew[cname]["groups"][0]
        for i, layer in enumerate(tnew[cname]):
            assert np.array_equal(layer["pos"].numpy(), np.asarray(jc["pos"][i]))
            np.testing.assert_allclose(layer["k"].numpy(),
                                       np.asarray(jc["k"][i]), atol=TOL, rtol=0)

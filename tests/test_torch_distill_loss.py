"""The port's distillation-loss kernels (plain versions and wrappers), its
fused loss and the kernel route of ``chunked_distill_loss``, against the
reference's Pallas kernels in interpret mode, its fused loss and its
``chunked_distill_loss``.

Inputs are drawn with numpy from a seed and fed to both packages. Both sides
compute in float32 from the same values and differ only in the order of
their sums (and in forming p as exp(x - lse) or as a softmax): tolerance
1e-5 on values, 1e-6 on logit gradients, whose entries are of order p."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import losses as jlosses
from repro.kernels import distill_loss as jdk
from repro.kernels import ref as jref
from repro.kernels.ops import fused_distill_loss as jfused
from repro.models import Model as JModel
from repro_torch.bridge import params_from_jax
from repro_torch.core import losses as tlosses
from repro_torch.kernels import distill_loss as tdk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import Model as TModel
from repro_torch.training.pretrain import value_and_grad
from torch_parity import port_config

TOL = 1e-5
GRAD_TOL = 1e-6
MODES = ["kld", "tvd", "tvdpp"]
# (N, V): V = 1000 is no multiple of the kernels' 512-wide vocab tile and
# N = 12 none of their 8-row tile
SHAPES = [(12, 1000), (8, 512)]


def _logits(seed, n, v):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n, v)) * 2).astype(np.float32)
    t = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    return s, t


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("n,v", SHAPES)
def test_plain_logsumexp_matches_oracle_and_pallas_kernel(n, v):
    s, _ = _logits(n + v, n, v)
    got = tref.ref_logsumexp(_t(s)).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jref.ref_logsumexp(s)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jdk.row_logsumexp(s, interpret=True)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,v", SHAPES)
def test_plain_terms_and_grad_match_pallas_kernels(mode, n, v):
    s, t = _logits(7 * n + v, n, v)
    lse_s, lse_t = (np.asarray(jref.ref_logsumexp(x)) for x in (s, t))
    mu, isg = np.float32(0.3), np.float32(2.0)
    want = jdk.loss_terms(s, t, lse_s, lse_t, jnp.asarray(mu), jnp.asarray(isg),
                          mode=mode, interpret=True)
    oracle = jref.ref_loss_terms(s, t, mu, isg, mode=mode)
    args = (_t(s), _t(t), _t(lse_s), _t(lse_t), _t([mu]), _t([isg]))
    got = tref.ref_loss_terms(*args, mode)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), atol=TOL, rtol=TOL)
    c = np.asarray(want[1])
    g_rows = np.random.default_rng(v).uniform(0.5, 1.5, n).astype(np.float32)
    want_g = jdk.loss_grad(s, t, lse_s, lse_t, c, g_rows, jnp.asarray(mu),
                           jnp.asarray(isg), mode=mode, interpret=True)
    got_g = tref.ref_loss_grad(*args[:4], _t(c), _t(g_rows), *args[4:], mode)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,v", SHAPES)
def test_fused_loss_value_and_grad_match_reference(mode, n, v):
    s, t = _logits(3 * n + v, n, v)
    mask = (np.random.default_rng(n).random(n) > 0.25).astype(np.float32)
    mask[0] = 0.0                                    # one masked-out row
    vr, gr = jax.value_and_grad(lambda x: jfused(mode, x, t, mask))(s)
    x = _t(s).requires_grad_()
    vt = ops.fused_distill_loss(mode, x, _t(t), _t(mask))
    (gt,) = torch.autograd.grad(vt, x)
    vt = vt.detach()
    assert abs(float(vt) - float(vr)) < TOL, (float(vt), float(vr))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gr), atol=GRAD_TOL, rtol=0)
    assert not gt[0].any()                           # the masked row
    # the fused loss equals the plain losses of core.losses
    np.testing.assert_allclose(float(tref.ref_distill_loss(mode, _t(s), _t(t), _t(mask))),
                               float(vt), atol=TOL, rtol=0)


def test_wrappers_send_cpu_tensors_to_plain_versions_uncounted():
    s, t = (_t(a) for a in _logits(1, 4, 300))
    ops.reset_launches()
    lse_s, lse_t = ops.row_logsumexp(s), ops.row_logsumexp(t)
    mu, isg = _t([0.1]), _t([1.5])
    terms = ops.loss_terms(s, t, lse_s, lse_t, mu, isg, "tvdpp")
    grad = ops.loss_grad(s, t, lse_s, lse_t, terms[1], _t(np.ones(4)), mu, isg,
                         "tvdpp")
    assert torch.equal(lse_s, tref.ref_logsumexp(s))
    want = tref.ref_loss_terms(s, t, lse_s, lse_t, mu, isg, "tvdpp")
    assert all(torch.equal(a, b) for a, b in zip(terms, want))
    assert torch.equal(grad, tref.ref_loss_grad(s, t, lse_s, lse_t, want[1],
                                                _t(np.ones(4)), mu, isg, "tvdpp"))
    ops.fused_distill_loss("tvdpp", s, t, _t(np.ones(4)))
    assert all(n == 0 for n in ops.LAUNCHES.values())


REJECT = {"cpu": "CUDA device", "dtype": "fp32 \\(N, V\\)",
          "rank": "fp32 \\(N, V\\)", "stride": "unit stride",
          "overlap": "unit stride", "rows": "lse_s", "scalar": "mu",
          "mode": "mode"}


@pytest.mark.parametrize("case", sorted(REJECT))
def test_kernel_wrappers_reject_what_they_cannot_launch(case):
    s, t = (_t(a) for a in _logits(2, 4, 64))
    lse, mu = _t(np.zeros(4)), _t([0.0])
    args = [s, t, lse, lse, mu, mu]
    mode = "tvdpp"
    if case == "dtype":
        args[0] = s.double()
    elif case == "rank":
        args[0] = s[None]
    elif case == "stride":
        args[0] = torch.cat([s, s], 1)[:, ::2]       # stride 2 along V
    elif case == "overlap":
        args[1] = t[:1].expand(4, 64)                # rows at stride 0
    elif case == "rows":
        args[2] = lse[:3]
    elif case == "scalar":
        args[4] = _t([0.0, 1.0])
    elif case == "mode":
        mode = "jsd"
    # every case fails the checks before any build or launch: the kernels
    # compute nothing on the CPU and never quietly take other inputs
    with pytest.raises(ValueError, match=REJECT[case]):
        tdk.loss_terms(*args, mode=mode)
    if case in ("cpu", "dtype", "rank", "stride"):
        with pytest.raises(ValueError, match=REJECT[case]):
            tdk.row_logsumexp(args[0])


# ---------------------------------------------------- chunked kernel route

def _chunk_setup():
    """A tiny model with two seeds of float32 weights on both sides and a
    batch of tokens (as tests/test_losses.py builds it)."""
    cfg = JConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                  attn_chunk=8, remat=False, dtype="float32")
    jm, tm = JModel(cfg), TModel(port_config(cfg), "cpu")
    jps = [jm.init(jax.random.PRNGKey(i))[0] for i in (0, 1)]
    tps = [params_from_jax(jax.tree.map(np.asarray, p), tm.cfg, "cpu")
           for p in jps]
    toks = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 5:9] = 0.0
    return cfg, jm, tm, jps, tps, toks, mask


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kind", MODES)
def test_chunked_distill_loss_matches_reference(kind, use_kernels):
    cfg, jm, tm, (jp1, jp2), (tp1, tp2), toks, mask = _chunk_setup()
    jh2, _ = jm.hidden(jp2, toks)

    def jloss(p):
        h, _ = jm.hidden(p, toks)
        return jlosses.chunked_distill_loss(kind, p, jp2, h, jh2, mask, cfg,
                                            cfg, chunk=4)

    vr, gr = jax.value_and_grad(jloss)(jp1)
    th2 = tm.hidden(tp2, torch.from_numpy(toks).long())

    def tloss(p):
        h = tm.hidden(p, torch.from_numpy(toks).long())
        return tlosses.chunked_distill_loss(kind, p, tp2, h, th2, _t(mask),
                                            tm.cfg, tm.cfg, chunk=4,
                                            use_kernels=use_kernels)

    vt, gt = value_and_grad(tloss, tp1)
    assert abs(float(vt) - float(vr)) < TOL, (float(vt), float(vr))
    want = params_from_jax(jax.tree.map(np.asarray, gr), tm.cfg, "cpu")
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), gt)),
                    jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), want))):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", MODES)
def test_chunked_kernel_route_launch_count(kind, monkeypatch):
    """The kernel route calls each kernel the number of times PERF.md
    derives (n chunks): 6n row_logsumexp, 3n loss_terms, n loss_grad for
    tvdpp; kld and tvd skip pass 1 (4n, 2n, n). On the CPU the wrappers run
    the plain versions, so the calls are counted there."""
    calls = {"ref_logsumexp": 0, "ref_loss_terms": 0, "ref_loss_grad": 0}
    for name in calls:
        fn = getattr(tref, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tref, name, counted)
    _, _, tm, _, (tp1, tp2), toks, mask = _chunk_setup()
    tok = torch.from_numpy(toks).long()
    th2 = tm.hidden(tp2, tok)
    value_and_grad(lambda p: tlosses.chunked_distill_loss(
        kind, p, tp2, tm.hidden(p, tok), th2, _t(mask), tm.cfg, tm.cfg,
        chunk=4, use_kernels=True), tp1)
    n = 16 // 4
    extra = 1 if kind == "tvdpp" else 0
    assert calls == {"ref_logsumexp": (4 + 2 * extra) * n,
                     "ref_loss_terms": (2 + extra) * n, "ref_loss_grad": n}

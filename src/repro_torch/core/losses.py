"""Distillation losses for draft-model fine-tuning (paper §2.3,
``repro.core.losses``).

Every loss takes student (draft) and teacher (target) logits over the full
vocabulary, plus a validity mask over token positions, and returns the mean
per-token loss. TVD++ is the paper's contribution: the gradient of TVD
(Lemma 1) as a policy gradient with reward r = 1{q > p}, its advantage
normalised by the p-weighted mean and standard deviation of r over all
tokens and the whole vocabulary, used as constants. The surrogate loss is
``-(1/n) sum_i sum_x p(x|i) * sg[(r(x, i) - mu) / sigma]``; see the
reference's module docstring for the sign convention.

``chunked_distill_loss`` computes these at large vocabulary chunk by chunk
of the sequence, in two passes for TVD++, never holding the (B, S, V)
logits of both models at once. With ``use_kernels`` it sends each chunk's
vocabulary reduction through the port's distill-loss kernels
(``kernels.ops``), which the reference's docstring names as the fusion of
that reduction; the plain route is the reference's arithmetic.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops

KERNEL_KINDS = ("kld", "tvd", "tvdpp")


def _masked_mean(x, mask):
    n = mask.sum().clamp(min=1.0)
    return (x * mask).sum() / n


def kld(s_logits, t_logits, mask, direction: str = "fwd"):
    """direction 'fwd': KL(q || p) (mass covering); 'bwd': KL(p || q)."""
    logp = torch.log_softmax(s_logits.float(), -1)
    logq = torch.log_softmax(t_logits.float(), -1)
    if direction == "fwd":
        per = (logq.exp() * (logq - logp)).sum(-1)
    elif direction == "bwd":
        per = (logp.exp() * (logp - logq)).sum(-1)
    else:
        raise ValueError(direction)
    return _masked_mean(per, mask)


def jsd(s_logits, t_logits, mask):
    logp = torch.log_softmax(s_logits.float(), -1)
    logq = torch.log_softmax(t_logits.float(), -1)
    p, q = logp.exp(), logq.exp()
    logm = torch.log(0.5 * (p + q) + 1e-20)
    per = 0.5 * (p * (logp - logm)).sum(-1) + 0.5 * (q * (logq - logm)).sum(-1)
    return _masked_mean(per, mask)


def tvd(s_logits, t_logits, mask):
    """0.5 * sum_x |q - p|; autodiff through p gives Lemma 1's gradient."""
    p = torch.softmax(s_logits.float(), -1)
    q = torch.softmax(t_logits.float(), -1)
    return _masked_mean(0.5 * (q - p).abs().sum(-1), mask)


def tvdpp_reward(p, q):
    return (q > p).float()


def tvdpp(s_logits, t_logits, mask, normalization: str = "weighted",
          eps: float = 1e-6):
    """TVD++ surrogate loss; mask (...,) over tokens."""
    p = torch.softmax(s_logits.float(), -1)
    q = torch.softmax(t_logits.float(), -1)
    r = tvdpp_reward(p, q)
    m = mask.float()[..., None]
    n_tok = mask.sum().clamp(min=1.0)
    if normalization == "weighted":
        w = p.detach() * m                     # X ~ p_theta sampling weights
        mu = (w * r).sum() / n_tok
        var = (w * (r - mu).square()).sum() / n_tok
    elif normalization == "flat":
        n_all = (mask.sum() * r.shape[-1]).clamp(min=1.0)
        mu = (m * r).sum() / n_all
        var = (m * (r - mu).square()).sum() / n_all
    else:
        raise ValueError(normalization)
    adv = ((r - mu) * torch.rsqrt(var + eps)).detach()
    per = -(p * adv).sum(-1)
    return _masked_mean(per, mask)


LOSSES = {"kld": kld, "jsd": jsd, "tvd": tvd, "tvdpp": tvdpp,
          "kld_bwd": lambda s, t, m: kld(s, t, m, direction="bwd")}


def distill_loss(kind: str, s_logits, t_logits, mask, **kw):
    return LOSSES[kind](s_logits, t_logits, mask, **kw)


# ------------------------------------------------------------- chunked loss

def chunked_distill_loss(kind, s_params, t_params, s_hidden, t_hidden, mask,
                         s_cfg, t_cfg, chunk: int = 512,
                         use_kernels: bool = False):
    """Two-pass sequence-chunked distillation loss at large vocabulary.

    s_hidden/t_hidden: (B, S, D*) final hidden states of draft/target; mask
    (B, S). Pass 1 (tvdpp only, no gradient) gives the global reward
    moments; pass 2 sums each chunk's loss times its token count. Each
    pass-2 chunk runs under ``torch.utils.checkpoint``: the (B, C, V) logits
    of both models exist only while one chunk is computed, forward or
    backward.

    ``use_kernels`` (kld, tvd, tvdpp) sends each chunk through the kernels:
    pass 1 runs two ``row_logsumexp`` and one ``loss_terms(mu=0,
    inv_sigma=1)``, whose masked ``sum p*r`` and ``sum p*r^2`` give mu and
    var; pass 2 runs ``ops.distill_core`` with those global constants (one
    chunk's own moments would normalise it differently: another loss).
    Per step, with n chunks, that is 6n ``row_logsumexp`` (pass 1, pass 2,
    and pass 2 again when backward recomputes a chunk), 3n ``loss_terms``
    and n ``loss_grad``.
    """
    from ..models import transformer as tfm

    if use_kernels and kind not in KERNEL_KINDS:
        raise ValueError(f"no kernel route for {kind!r}; use one of "
                         f"{KERNEL_KINDS}")
    S = mask.shape[1]
    C = chunk if S % chunk == 0 and S > chunk else S
    spans = [slice(i, i + C) for i in range(0, S, C)]
    mask = mask.float()
    n_tok = mask.sum().clamp(min=1.0)

    def logits(hs, ht):
        ls = tfm.logits_from_hidden(s_params, hs, s_cfg)
        with torch.no_grad():
            lt = tfm.logits_from_hidden(t_params, ht, t_cfg)
        return ls, lt

    def rows(x):
        return x.reshape(-1, x.shape[-1])

    dev = s_hidden.device
    mu = torch.zeros((1,), dtype=torch.float32, device=dev)
    inv_sigma = torch.ones((1,), dtype=torch.float32, device=dev)
    if kind == "tvdpp":
        # ---- pass 1: global moments, no gradient --------------------------
        s1, s2 = [], []
        with torch.no_grad():
            for sp in spans:
                ls, lt = logits(s_hidden[:, sp], t_hidden[:, sp])
                mk = mask[:, sp]
                if use_kernels:
                    ls, lt, mk = rows(ls), rows(lt), mk.reshape(-1)
                    lse_s, lse_t = ops.row_logsumexp(ls), ops.row_logsumexp(lt)
                    _, _, r1, r2 = ops.loss_terms(ls, lt, lse_s, lse_t, mu,
                                                  inv_sigma, "tvdpp")
                    s1.append((r1 * mk).sum())
                    s2.append((r2 * mk).sum())
                else:
                    p, q = torch.softmax(ls, -1), torch.softmax(lt, -1)
                    r = tvdpp_reward(p, q)
                    w = p * mk[..., None]
                    s1.append((w * r).sum())
                    s2.append((w * r * r).sum())
            mu = (torch.stack(s1).sum() / n_tok).reshape(1)
            var = torch.stack(s2).sum() / n_tok - mu * mu
            inv_sigma = torch.rsqrt(var.clamp(min=0.0) + 1e-6)

    # ---- pass 2: each chunk's loss times its token count ------------------
    def chunk_loss(hs, ht, mk):
        ls, lt = logits(hs, ht)
        n_c = mk.sum().clamp(min=1.0)
        if use_kernels:
            return ops.distill_core(kind, rows(ls), rows(lt), mk.reshape(-1),
                                    mu, inv_sigma) * n_c
        if kind != "tvdpp":
            return distill_loss(kind, ls, lt, mk) * n_c
        p, q = torch.softmax(ls, -1), torch.softmax(lt, -1)
        adv = ((tvdpp_reward(p, q) - mu) * inv_sigma).detach()
        return (-(p * adv).sum(-1) * mk).sum()

    sums = [checkpoint(chunk_loss, s_hidden[:, sp], t_hidden[:, sp],
                       mask[:, sp], use_reentrant=False) for sp in spans]
    return torch.stack(sums).sum() / n_tok

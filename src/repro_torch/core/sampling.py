"""Token sampling: temperature / top-p / greedy, plus the speculative
residual sample (``repro.core.sampling``).

Categorical sampling is the Gumbel-max rule ``argmax(log p + g)``, which is
how ``jax.random.categorical`` samples. Each sampler draws its noise from
an explicit ``torch.Generator``, or takes it as a tensor (``noise``) so
that a test can hand it the noise the reference drew and get its token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def probs_from_logits(logits, temperature: float = 1.0, top_p: float = 1.0):
    """logits (..., V) -> sampling distribution (..., V), float32.
    temperature 0 gives the one-hot argmax (greedy)."""
    logits = logits.float()
    V = logits.shape[-1]
    if temperature == 0.0:
        return F.one_hot(logits.argmax(-1), V).float()
    p = torch.softmax(logits / temperature, dim=-1)
    if top_p < 1.0:
        sorted_p = p.sort(dim=-1, descending=True).values
        csum = sorted_p.cumsum(-1)
        # smallest set with cumulative mass >= top_p. With top_p just below
        # 1 the float32 cumsum can stay below it everywhere; the reference's
        # index then reaches V and its distribution becomes all zeros, so
        # the index is clamped to the last entry here.
        cutoff_idx = (csum < top_p).sum(-1, keepdim=True).clamp(max=V - 1)
        cutoff = sorted_p.gather(-1, cutoff_idx)
        p = torch.where(p >= cutoff, p, 0.0)
        p = p / p.sum(-1, keepdim=True).clamp(min=1e-20)
    return p


def gumbel(shape, gen, device):
    """Standard Gumbel noise drawn from ``gen``."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_from_probs(probs, gen=None, noise=None):
    """Categorical sample; probs (..., V) -> ids (...). ``noise`` is Gumbel
    noise of probs' shape; without it the noise is drawn from ``gen``."""
    if noise is None:
        noise = gumbel(probs.shape, gen, probs.device)
    return (noise + torch.log(probs.clamp(min=1e-30))).argmax(-1)


def residual_sample(q, p, gen=None, noise=None):
    """Leviathan rejection-sampling residual: sample from norm(max(q-p, 0)),
    or from q when the residual has no mass (p == q)."""
    res = (q - p).clamp(min=0.0)
    mass = res.sum(-1, keepdim=True)
    dist = torch.where(mass > 1e-9, res / mass.clamp(min=1e-30), q)
    return sample_from_probs(dist, gen, noise)

"""Masked greedy and nucleus sampling on pre-drawn Gumbel noise, batched.

Port of ``smer_music_generation_tpu/infer/sampling.py`` (``greedy_sample``
:42, ``nucleus_log_probs`` :47, ``spec_accept_resample`` :76,
``masked_sample_gumbel`` :115).  The noise is an input tensor, so the same
noise handed to both packages gives the same tokens.

Nucleus rule (sort-free, as in the JAX package): a token is kept iff the
total probability strictly above its own is < p; kept tokens carry their
log-prob, dropped and banned tokens -1e9; the sample is
``argmax(log-probs + gumbel)``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def greedy_sample(logits: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    masked = torch.where(allowed, logits, NEG_INF)
    return torch.argmax(masked, dim=-1)


def nucleus_log_probs(
    logits: torch.Tensor,  # (B, V) f32
    allowed: torch.Tensor,  # (B, V) bool
    p: Optional[float] = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    masked = torch.where(allowed, logits, NEG_INF) / temperature
    # jax.nn.log_softmax's formula, so both packages round alike
    shifted = masked - masked.amax(dim=-1, keepdim=True)
    logp = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    if p is not None:
        probs = torch.exp(logp)
        above = torch.sum(
            probs[:, None, :] * (probs[:, None, :] > probs[:, :, None]), dim=-1
        )
        logp = torch.where(above < p, logp, NEG_INF)
    return logp


def spec_accept_resample(
    u: torch.Tensor,  # (B,) f32 Uniform(0, 1): the acceptance draw
    gumbel: torch.Tensor,  # (B, V) f32: the residual's resample noise
    logits: torch.Tensor,  # (B, V) f32
    allowed: torch.Tensor,  # (B, V) bool
    draft: torch.Tensor,  # (B,) proposed token
    p: Optional[float] = None,
    temperature: float = 1.0,
):
    """One speculative-sampling step against a deterministic (point-mass)
    draft: accept ``draft`` with probability P(draft), P the masked nucleus
    distribution renormalised over its kept support; otherwise take the
    argmax of the residual (the kept support without the draft) plus the
    Gumbel row.  The emitted token is distributed exactly as P.  Returns
    ``(token (B,), accepted (B,) bool)``."""
    logp = nucleus_log_probs(logits, allowed, p, temperature)
    kept = logp > NEG_INF / 2
    norm = torch.where(kept, torch.exp(logp), 0.0).sum(dim=-1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    draft = draft.long()
    p_draft = torch.exp(logp[rows, draft]) / norm.clamp(min=1e-38)
    accepted = u < p_draft
    excl = logp.clone()
    excl[rows, draft] = NEG_INF
    # all mass on the draft leaves the residual empty, but then the draft
    # is accepted with probability 1 and this argmax is never taken
    alt = torch.argmax(excl + gumbel, dim=-1)
    return torch.where(accepted, draft, alt), accepted


def masked_sample_gumbel(
    gumbel: torch.Tensor,  # (B, V) f32 Gumbel(0, 1) noise
    logits: torch.Tensor,  # (B, V) f32
    allowed: torch.Tensor,  # (B, V) bool
    p: Optional[float] = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    return torch.argmax(
        nucleus_log_probs(logits, allowed, p, temperature) + gumbel, dim=-1
    )


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise, -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))

"""Masked greedy and nucleus sampling on pre-drawn Gumbel noise, batched.

Port of ``smer_music_generation_tpu/infer/sampling.py`` (``greedy_sample``
:42, ``nucleus_log_probs`` :47, ``masked_sample_gumbel`` :115).  The noise
is an input tensor, so the same noise handed to both packages gives the
same tokens.

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

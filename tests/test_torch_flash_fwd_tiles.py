"""The flash-train forward's order of work: ``flash_train_fwd_kernel``
(``ops/csrc/flash_train.cu``) cannot run here, so ``fwd_tiles`` walks it: a
block per 128 query rows; the 128-key blocks in order, when causal those at
or below the rows' block; per block the scores s scale + the additive mask,
m stepped once a block, p = 2^((s - m) log2 e), each lane's partial sum of p
over its 32 columns (pairs 8 j + 2 t, 8 j + 2 t + 1 in order of j) rescaled
as m grows, the quad's four added as (0 + 1) + (2 + 3) at the end; O = O
alpha + bf16(p) V; out = bf16(O / l), or, when S is one block, bf16(p / l) V.

Tolerances: against the twin, the output within the bound the card holds the
kernel to (``chip_smoke.TA_ATOL``/``TA_RTOL``, one bf16 ulp), m and l within
1e-6 relative norm (the same f32 values summed in another order); against
JAX's library kernel in interpret mode as the twin is held
(``tests/test_torch_wide_attention.py``).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import TA_ATOL, TA_RTOL
from smer_music_generation_tpu_torch.ops import flash_train as ft
from tests.test_torch_wide_attention import FT_REL, _jax_flash, _normal, _rel, _valid

BLK = 128
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MASK = torch.tensor(-0.7 * float(torch.finfo(torch.float32).max), dtype=torch.float32)


def _quad(x: torch.Tensor) -> torch.Tensor:
    """The four lanes' partial sums added as the quad's shuffles add them."""
    return (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])


def fwd_tiles(q, k, v, valid, causal):
    """(out bf16 (B, T, H, D), stats (2, B*H, T): m, l) in
    ``flash_train_fwd_kernel``'s order of work."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    okk = valid.to(torch.bool)[:, None, None, :]
    single = S == BLK
    rows, keys = torch.arange(T), torch.arange(S)
    out = torch.zeros(B, H, T, D)
    m_all, l_all = torch.zeros(B, H, T), torch.zeros(B, H, T)
    for qb in range(T // BLK):  # a block per 128 query rows
        r = slice(qb * BLK, (qb + 1) * BLK)
        m = torch.full((B, H, BLK), -torch.inf)
        lp = torch.zeros(B, H, BLK, 4)  # each lane's partial sum of p
        o = torch.zeros(B, H, BLK, D)
        for i in range(min(qb + 1, S // BLK) if causal else S // BLK):
            c = slice(i * BLK, (i + 1) * BLK)
            ok = okk[..., c]
            if causal and i == qb:
                ok = ok & (keys[c][None, :] <= rows[r][:, None])
            s = (qf[:, :, r] @ kf[:, :, c].transpose(-1, -2)) * scale + torch.where(ok, 0.0, MASK)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new[..., None]) * LOG2E)
            # lane t holds the columns 8 j + 2 t and 8 j + 2 t + 1: pair 4 j + t
            pairs = (p[..., 0::2] + p[..., 1::2]).reshape(B, H, BLK, 16, 4)
            sums = torch.zeros(B, H, BLK, 4)
            for j in range(16):
                sums = sums + pairs[..., j, :]
            if single:
                lp = sums
                p = p / _quad(sums)[..., None]
            else:  # l = fma(alpha, l, sum): one rounding
                lp = (alpha[..., None].double() * lp.double() + sums.double()).float()
            m = m_new
            o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, c]
        l = _quad(lp)
        out[:, :, r] = o if single else o * (1.0 / l)[..., None]
        m_all[:, :, r], l_all[:, :, r] = m, l
    stats = torch.stack([m_all.reshape(B * H, T), l_all.reshape(B * H, T)])
    return out.permute(0, 2, 1, 3).to(q.dtype), stats


FWD_CASES = [(t, s, False) for t in (128, 256, 384) for s in (128, 256, 384)] + \
            [(t, t, True) for t in (128, 256, 384)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,S,causal", FWD_CASES,
                         ids=[f"T{t}-S{s}-{'causal' if c else 'full'}" for t, s, c in FWD_CASES])
def test_fwd_tiles_match_twin_and_jax(T, S, causal, D):
    """The forward's order against the twin and JAX's library kernel, with
    a batch row of no valid key (its rows weigh their visited keys alike)."""
    rng = np.random.default_rng(T + 3 * S + D)
    q, k, v = _normal(rng, (2, T, 2, D), (2, S, 2, D), (2, S, 2, D))
    valid = _valid(2, S, seed=T + S)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    got, stats = fwd_tiles(tq, tk, tv, tvalid, causal)
    want, want_stats = ft.flash_train_fwd_reference(tq, tk, tv, tvalid, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=TA_ATOL, rtol=TA_RTOL)
    assert torch.equal(stats[0], want_stats[0]) or _rel(stats[0], want_stats[0]) < 1e-6
    assert _rel(stats[1], want_stats[1]) < 1e-6
    (jout,) = _jax_flash(q, k, v, valid, None, causal, torch.bfloat16)
    assert _rel(got, jout) < FT_REL[torch.bfloat16][0]

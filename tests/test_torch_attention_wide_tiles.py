"""The wide attention kernels' order of work (head_dim above 128), emulated
in plain torch on the CPU against the port's twins.

``ops/csrc/attention_wide.cu`` cannot run here, so the emulations below
walk its order: a block of 64 rows (query rows; keys in the keys kernel)
and one 128-column chunk of the output; tiles of 128 columns (keys; query
rows in the keys kernel), each tile's scores summed over head_dim in chunks
of 64; the row statistics recomputed by every chunk's block; the weights
(or ds) times the other operand 64 rows at a time.  MODE 0
(``fused_attention``): an online softmax, -1e30 on masked keys, columns past
S out; MODE 1 (``fused_dropout_attention``): a first pass for m and l, a
second for w = bf16(e / max(l, 1e-30)) and the keep hash's dropout; its
rows kernel m, l and delta = u / max(l, 1e-30) with u = sum e dw rescaled
online; MODE 2 (``flash_training``): m stepping by 128-key block, the
additive mask, a causal row visiting the blocks at or below its own, at S
= 128 bf16(p / l).

Each emulation is held to its twin at head_dim 160 (zero-padded to 192),
192 (three chunks; two output chunks, the second 64 wide) and 256 within
the bounds ``chip_smoke.py`` holds the kernels to: phase 2f's
(``ATTN_ATOL``/``ATTN_RTOL``) and the f32 ``F32_ATOL``/``F32_RTOL`` for
MODE 0; phase 2g's (``TA_ATOL``/``TA_RTOL`` for the output, ``TA_REL`` for
the gradients) for MODE 1; phase 2j's for MODE 2 (``TA_*`` in bf16,
``F32_*`` and ``F32_REL`` in f32).  The padded columns of every output and
gradient are exactly zero.  Also: which head_dims the wrappers send to the
wide kernels.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_ATOL, ATTN_RTOL, F32_ATOL, F32_REL, F32_RTOL, TA_ATOL, TA_REL,
                        TA_RTOL)
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import attention_wide as aw
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta

FUSED, DROP, FLASH = aw.MODE_FUSED, aw.MODE_DROP, aw.MODE_FLASH
BR, BC, DC, OC = 64, 128, 64, 128  # block rows, tile columns, head_dim chunk, output chunk
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
HEAD_DIMS = (160, 192, 256)


def _ex2(x):
    return torch.exp2(x * LOG2E)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bh(x):
    """(B, L, H, D) -> (B*H, L, D) f32."""
    B, L, H, D = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(B * H, L, D)


def _unbh(x, B, H, dtype):
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).permute(0, 2, 1, 3).to(dtype)


def _scores(A, B_):
    """A (BH, r, D) . B (BH, n, D)^T summed over head_dim in chunks of 64."""
    acc = torch.zeros(A.shape[0], A.shape[1], B_.shape[1])
    for d0 in range(0, A.shape[2], DC):
        acc = acc + A[..., d0:d0 + DC] @ B_[..., d0:d0 + DC].transpose(1, 2)
    return acc


def _product(P, M):
    """P (BH, r, n) times M (BH, n, c), 64 rows of M at a time."""
    acc = torch.zeros(P.shape[0], P.shape[1], M.shape[2])
    for h in range(0, P.shape[2], 64):
        acc = acc + P[..., h:h + 64] @ M[:, h:h + 64]
    return acc


def _key_ok(mode, B, H, T, S, lens, valid, causal):
    """(BH, T, S): key attendable from the row."""
    if mode == FUSED:
        ok = torch.ones(B, S, dtype=torch.bool) if lens is None else \
            torch.arange(S)[None, :] < lens[:, None]
    else:
        ok = valid.bool()
    ok = ok[:, None, None, :].expand(B, H, T, S)
    if causal:
        ok = ok & torch.ones(T, S, dtype=torch.bool).tril()
    return ok.reshape(B * H, T, S)


def _k_end(mode, causal, t0, S):
    if causal and mode == FLASH:
        return min(S, (t0 // BC + 1) * BC)
    if causal and mode == DROP:
        return min(S, t0 + BR)
    return S


def _masked(mode, s, ok, scale):
    if mode == FUSED:
        return torch.where(ok, s * scale, -1e30)
    if mode == DROP:
        return torch.where(ok, _bf16(s) * scale, -torch.inf)
    return s * scale + torch.where(ok, 0.0, ft.MASK_VALUE)


def fwd_emulation(mode, q, k, v, scale, lens=None, valid=None, causal=False, keep=None, rate=0.0):
    """wide_fwd_kernel's order: (out (B, T, H, D) in q's dtype, stats
    (2, B*H, T) for MODE 2)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dt = q.dtype
    Q, K, V = _bh(q), _bh(k), _bh(v)
    ok_all = _key_ok(mode, B, H, T, S, lens, valid, causal)
    keep = None if keep is None else keep.reshape(B * H, T, S)
    c = ta.bf16_round(1.0 - rate)
    out = torch.zeros(B * H, T, D)
    stats = torch.zeros(2, B * H, T)
    one_block = mode == FLASH and S == BC
    for t0 in range(0, T, BR):
        r = slice(t0, min(t0 + BR, T))
        for c0 in range(0, D, OC):
            cs = slice(c0, min(c0 + OC, D))
            m = torch.full((B * H, r.stop - t0), -1e30 if mode == DROP else -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(B * H, r.stop - t0, cs.stop - c0)
            for pass_ in ((0, 1) if mode == DROP else (1,)):
                for k0 in range(0, _k_end(mode, causal, t0, S), BC):
                    ks = slice(k0, min(k0 + BC, S))
                    x = _masked(mode, _scores(Q[:, r], K[:, ks]), ok_all[:, r, ks], scale)
                    if mode == DROP and pass_ == 1:
                        e = torch.where(x == -torch.inf, 0.0, _ex2(x - m[..., None]))
                        wd = _bf16(e / l.clamp(min=1e-30)[..., None])
                        if rate > 0.0:
                            wd = torch.where(keep[:, r, ks], _bf16(wd / c), 0.0)
                        acc = acc + _product(wd, V[:, ks, cs])
                        continue
                    tmax = x.amax(-1)
                    if mode == DROP:
                        tmax = tmax.clamp(min=-1e30)
                    m_new = torch.maximum(m, tmax)
                    alpha = _ex2(m - m_new)
                    p = torch.where(x == -torch.inf, 0.0, _ex2(x - m_new[..., None]))
                    l = l * alpha + p.sum(-1)
                    m = m_new
                    if mode == DROP:
                        continue
                    acc = acc * alpha[..., None]
                    if mode == FLASH:
                        p = (p / l[..., None] if one_block else p).to(dt).float()
                    acc = acc + _product(p, V[:, ks, cs])
            mul = 1.0 if mode == DROP or one_block else (1.0 / l)[..., None]
            out[:, r, cs] = acc * mul
            if c0 == 0:
                stats[0, :, r], stats[1, :, r] = m, l
    return _unbh(out, B, H, dt), stats


def bwd_emulation(mode, q, k, v, g, scale, valid, causal=False, keep=None, rate=0.0, out=None,
                  stats=None):
    """wide_rows_kernel then wide_keys_kernel: (dq, dk, dv) in q's dtype.
    MODE 1 recomputes m, l and delta in the rows kernel; MODE 2 takes the
    forward's m and l and di = sum(out g)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dt = q.dtype
    Q, K, V, G = _bh(q), _bh(k), _bh(v), _bh(g)
    ok_all = _key_ok(mode, B, H, T, S, None, valid, causal)
    keep = None if keep is None else keep.reshape(B * H, T, S)
    c = ta.bf16_round(1.0 - rate)
    dq, dk, dv = (torch.zeros(B * H, n, D) for n in (T, S, S))
    st = torch.zeros(3, B * H, T)  # MODE 1: m, l, delta; MODE 2: m, 1 / l, di
    if mode == FLASH:
        st[0], st[1] = stats[0], 1.0 / stats[1]
        st[2] = (_bh(out) * G).sum(-1)

    def dropped(dp, kp):
        return torch.where(kp, dp / c, 0.0) if rate > 0.0 else dp

    for t0 in range(0, T, BR):  # the rows kernel
        r = slice(t0, min(t0 + BR, T))
        k_end = _k_end(mode, causal, t0, S)
        for c0 in range(0, D, OC):
            cs = slice(c0, min(c0 + OC, D))
            if mode == DROP:
                m = torch.full((B * H, r.stop - t0), -1e30)
                l, u = torch.zeros_like(m), torch.zeros_like(m)
                for k0 in range(0, k_end, BC):
                    ks = slice(k0, min(k0 + BC, S))
                    x = _masked(mode, _scores(Q[:, r], K[:, ks]), ok_all[:, r, ks], scale)
                    dw = dropped(_scores(G[:, r], V[:, ks]), None if keep is None else keep[:, r, ks])
                    m_new = torch.maximum(m, x.amax(-1).clamp(min=-1e30))
                    alpha = _ex2(m - m_new)
                    e = torch.where(x == -torch.inf, 0.0, _ex2(x - m_new[..., None]))
                    l = l * alpha + e.sum(-1)
                    u = u * alpha + (e * dw).sum(-1)
                    m = m_new
                delta = u / l.clamp(min=1e-30)
                if c0 == 0:
                    st[0, :, r], st[1, :, r], st[2, :, r] = m, l, delta
                m, l, d = m, l.clamp(min=1e-30), delta
            else:
                m, l, d = st[0, :, r], st[1, :, r], st[2, :, r]
            acc = torch.zeros(B * H, r.stop - t0, cs.stop - c0)
            for k0 in range(0, k_end, BC):
                ks = slice(k0, min(k0 + BC, S))
                x = _masked(mode, _scores(Q[:, r], K[:, ks]), ok_all[:, r, ks], scale)
                dp = _scores(G[:, r], V[:, ks])
                if mode == DROP:
                    w = torch.where(x == -torch.inf, 0.0, _ex2(x - m[..., None]) / l[..., None])
                    dw = dropped(dp, None if keep is None else keep[:, r, ks])
                    ds = _bf16(w * (dw - d[..., None]) * scale)
                else:
                    p = _ex2(x - m[..., None]) * l[..., None]
                    ds = ((dp - d[..., None]) * p * scale).to(dt).float()
                acc = acc + _product(ds, K[:, ks, cs])
            dq[:, r, cs] = acc
    if mode == DROP:
        st[1] = st[1].clamp(min=1e-30)
    okT = ok_all.transpose(1, 2)  # (BH, S, T)
    keepT = None if keep is None else keep.transpose(1, 2)
    for s0 in range(0, S, BR):  # the keys kernel
        kr = slice(s0, min(s0 + BR, S))
        t_begin = (s0 // BC) * BC if causal else 0
        for c0 in range(0, D, OC):
            cs = slice(c0, min(c0 + OC, D))
            adk = torch.zeros(B * H, kr.stop - s0, cs.stop - c0)
            adv = torch.zeros_like(adk)
            for t0 in range(t_begin, T, BC):
                ts = slice(t0, min(t0 + BC, T))
                m, l, d = (st[i, :, ts][:, None, :] for i in range(3))
                sT = _scores(K[:, kr], Q[:, ts])
                ok = okT[:, kr, ts]
                if mode == DROP:
                    w = torch.where(ok, _ex2(_bf16(sT) * scale - m) / l, 0.0)
                    kp = None if keepT is None else keepT[:, kr, ts]
                    wd = _bf16(w)
                    if rate > 0.0:
                        wd = torch.where(kp, _bf16(wd / c), 0.0)
                    adv = adv + _product(wd, G[:, ts, cs])
                    dw = dropped(_scores(V[:, kr], G[:, ts]), kp)
                    ds = torch.where(w == 0.0, 0.0, _bf16(w * (dw - d) * scale))
                else:
                    p = _ex2(sT * scale + torch.where(ok, 0.0, ft.MASK_VALUE) - m) * l
                    adv = adv + _product(p.to(dt).float(), G[:, ts, cs])
                    ds = ((_scores(V[:, kr], G[:, ts]) - d) * p * scale).to(dt).float()
                adk = adk + _product(ds, Q[:, ts, cs])
            dk[:, kr, cs], dv[:, kr, cs] = adk, adv
    return tuple(_unbh(x, B, H, dt) for x in (dq, dk, dv))


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-12))


def _inputs(hd, dtype, B=2, T=256, S=256, H=2, seed=0):
    g = np.random.default_rng(seed + hd)
    mk = lambda n: torch.from_numpy(g.standard_normal((B, n, H, hd)).astype(np.float32)).to(dtype)  # noqa: E731
    valid = torch.from_numpy(g.random((B, S)) < 0.9)
    valid[0, :3] = False  # row 0's first causal rows have no key
    valid[1, 0] = True
    return mk(T), mk(S), mk(S), mk(T), valid


def _padded(hd, *ts):
    return [attn.pad_head(t, aw.wide_width(hd)) for t in ts]


def _sliced(hd, t):
    assert (t[..., hd:] == 0).all()
    return t[..., :hd]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_fused_attention_wide_order_against_twin(hd, causal, dtype):
    """MODE 0 at T=200, S=333 (a ragged tile and a ragged block), a batch
    row with no valid key (all S keys weigh alike) and one with a length."""
    q, k, v, _, _ = _inputs(hd, dtype, T=200, S=333)
    lens = torch.tensor([0, 250], dtype=torch.int32)
    pq, pk, pv = _padded(hd, q, k, v)
    got, _ = fwd_emulation(FUSED, pq, pk, pv, 1 / math.sqrt(hd), lens=lens, causal=causal)
    want = attn.attention_reference(q, k, v, lens, causal)
    atol, rtol = (F32_ATOL, F32_RTOL) if dtype == torch.float32 else (ATTN_ATOL, ATTN_RTOL)
    torch.testing.assert_close(_sliced(hd, got).float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("rate,causal", [(0.1, False), (0.1, True), (0.0, False)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_dropout_attention_wide_order_against_twin(hd, rate, causal):
    """MODE 1, forward and backward pair, at T=192 (a block of 64 past the
    128-row tile), S=320, the keep mask of the kernels' hash at a shard's
    global (b, h)."""
    q, k, v, g, valid = _inputs(hd, torch.bfloat16, T=192, S=320)
    seed, shard = (3, 9), (1, 2, 5)
    keep = ta.dropout_mask_reference(seed, 2, 2, 192, 320, rate, None, *shard) if rate else None
    pq, pk, pv, pg = _padded(hd, q, k, v, g)
    sc = 1 / math.sqrt(hd)
    got, _ = fwd_emulation(DROP, pq, pk, pv, sc, valid=valid, causal=causal, keep=keep, rate=rate)
    want = ta.dropout_attention_fwd_reference(q, k, v, valid, seed, rate, causal, shard)
    torch.testing.assert_close(_sliced(hd, got).float(), want.float(), atol=TA_ATOL, rtol=TA_RTOL)
    grads = bwd_emulation(DROP, pq, pk, pv, pg, sc, valid, causal, keep, rate)
    twins = ta.dropout_attention_bwd_reference(q, k, v, valid, seed, g, rate, causal, shard)
    for name, a, b in zip(("dq", "dk", "dv"), grads, twins):
        assert _rel(_sliced(hd, a), b) < TA_REL[name], (name, _rel(_sliced(hd, a), b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T,S,causal", [(256, 256, True), (128, 384, False), (256, 128, False)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_train_wide_order_against_twin(hd, T, S, causal, dtype):
    """MODE 2, forward (m and l too) and backward pair; S = 128 is the
    library's one-step kernel."""
    q, k, v, g, valid = _inputs(hd, dtype, T=T, S=S)
    pq, pk, pv, pg = _padded(hd, q, k, v, g)
    sc = 1 / math.sqrt(hd)
    got, stats = fwd_emulation(FLASH, pq, pk, pv, sc, valid=valid, causal=causal)
    want, want_stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    f32 = dtype == torch.float32
    atol, rtol = (F32_ATOL, F32_RTOL) if f32 else (TA_ATOL, TA_RTOL)
    torch.testing.assert_close(_sliced(hd, got).float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(stats, want_stats, atol=0, rtol=1e-5)
    grads = bwd_emulation(FLASH, pq, pk, pv, pg, sc, valid, causal, out=attn.pad_head(want, pq.shape[-1]),
                          stats=want_stats)
    twins = ft.flash_train_bwd_reference(q, k, v, valid, want, want_stats, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, twins):
        bound = F32_REL if f32 else TA_REL[name]
        assert _rel(_sliced(hd, a), b) < bound, (name, _rel(_sliced(hd, a), b))


@pytest.mark.parametrize("hd,width", [(129, 192), (160, 192), (192, 192), (200, 256), (256, 256),
                                      (320, 320), (512, 512)])
def test_wide_head_dims_route_to_the_wide_kernels(hd, width):
    """Above 128 every wrapper pads to the next multiple of 64 and takes the
    wide kernels, in bf16 and f32 alike; 128 and below keep the narrow
    kernels' widths."""
    assert aw.is_wide(hd) and attn.kernel_width(hd) == width
    for dtype in (torch.bfloat16, torch.float32):
        assert ft.flash_kernel_width(hd, dtype) == width
    assert not aw.is_wide(128) and attn.kernel_width(128) == 128

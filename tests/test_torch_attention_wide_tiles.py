"""The wide attention kernels' order of work (head_dim above 128), emulated
in plain torch on the CPU against the port's twins.

``ops/csrc/attention_wide.cu`` cannot run here, so the emulations below
walk its order.  All three kernels run on the tensor cores.
``wide_fwd_kernel`` and ``wide_rows_kernel``: a block of 64 query rows; key
tiles of 64 (MODE 2's forward takes them in pairs, so its m steps by the
library's 128-key block); each tile's scores (and g V^T) summed over
head_dim in one chain, chunk after chunk; the output taken tile after tile
into one accumulator.  bf16: the
products of bf16 operands summed in f32 over chunks of 64; P (MODE 0's f32
weights) applied as bf16(P) plus bf16(P - bf16(P)), MODE 1's wd and ds and
MODE 2's cast(p) and ds as one bf16 operand (exact).  f32: every product in
split TF32 (``tests/test_torch_f32_split_tiles.py``'s ``chain``: hi = x
rounded to TF32, lo = x - hi read as TF32, k8 steps of lo hi, hi lo, hi hi
into one accumulator rounded toward zero), nothing rounded to bf16.  MODE 0
(``fused_attention``): an online softmax, -1e30 on masked keys, columns past
S out; MODE 1 (``fused_dropout_attention``): a first pass for m and l, a
second for w = bf16(e / max(l, 1e-30)) and the keep hash's dropout; its rows
kernel m, l and delta = u / max(l, 1e-30) with u = sum e dw rescaled online;
MODE 2 (``flash_training``): the additive mask, a causal row visiting the
blocks at or below its own, at S = 128 bf16(p / l).  ``wide_keys_kernel``
swaps the roles: a block of 64 keys walks query tiles of 64 (causal: MODE 1
from the tile of its first key, MODE 2 from its 128-key block's first row),
S^T = K Q^T summed in the rows kernel's order (split TF32's cross passes
swapped: hi_k lo_q, lo_k hi_q, hi hi), w or p by the rows kernel's formulas
from its statistics, and dk and dv as two walks (the kernel's dk and dv
blocks): a dv walk sums wd^T g or cast(p)^T g, a dk walk takes (g V^T)^T
and sums ds^T Q.  MODE 0's tiles past the last valid key (and past the
block's last row when causal) add exact zeros, so the emulation walks every
tile.

Each emulation is held to its twin at head_dim 160 (zero-padded to 192),
192 (three bf16 chunks; two output chunks, the second 64 wide) and 256
within the bounds ``chip_smoke.py`` holds the kernels to: phase 2f's
(``ATTN_ATOL``/``ATTN_RTOL``) and the f32 ``F32_ATOL``/``F32_RTOL`` for
MODE 0; phase 2g's (``TA_ATOL``/``TA_RTOL`` for the output, ``TA_REL`` for
the gradients) for MODE 1; phase 2j's for MODE 2 (``TA_*`` in bf16,
``F32_*`` and ``F32_REL`` in f32).  The padded columns of every output and
gradient are exactly zero.  Two controls: MODE 0 with P rounded once to
bf16 leaves phase 2f's bound on a peaked softmax at head_dim 256, and one
TF32 pass (hi hi alone) leaves the f32 bounds.  Also: the keys kernel's
S^T equal bit for bit to the rows kernel's s (the unswapped cross passes
are the control), its transposed keep bits equal to ``keep_bits``', dk and
dv from two walks equal to one walk's, and which head_dims the wrappers
send to the wide kernels.
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
from tests.test_torch_f32_split_tiles import add_toward_zero, chain, split

FUSED, DROP, FLASH = aw.MODE_FUSED, aw.MODE_DROP, aw.MODE_FLASH
BR, BLK, DC = 64, 128, 64  # block rows (the keys kernel's query tile); the library's block; a bf16 chunk
KEYS = 64  # the key tile (MODE 2's forward: a pair); the keys kernel's block of keys
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
HEAD_DIMS = (160, 192, 256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The split-TF32 chains take thousands of tiny float64 products, which
    a torch thread pool runs no faster and, when the other test workers hold
    the cores, much slower: one thread runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """A (BH, r, D) . B (BH, n, D)^T summed over head_dim in chunks of 64 (the
    tensor cores' order in bf16, whose products of bf16 operands are exact in
    f32)."""
    acc = torch.zeros(A.shape[0], A.shape[1], B_.shape[1])
    for d0 in range(0, A.shape[2], DC):
        acc = acc + A[..., d0:d0 + DC] @ B_[..., d0:d0 + DC].transpose(1, 2)
    return acc


def _tc_scores(A, B_, f32, passes=0):
    """The tensor-core kernels' scores: bf16 as :func:`_scores`; f32 with
    ``passes`` 3 one split-TF32 chain over head_dim (1: hi hi alone; 0: the
    f32 products as :func:`_scores` sums them)."""
    return chain(A, B_.transpose(1, 2), passes=passes) if f32 and passes else _scores(A, B_)


def _tc_chain(a, b, passes=3, swap=False, step=8):
    """a (..., M, K) b (..., K, N) as the tensor cores sum it in ``chain``'s
    model: k steps of ``step`` in order, each pass's products exact
    (float64) and added to an f32 accumulator rounded toward zero.  passes
    3: split TF32's lo_a hi_b, hi_a lo_b, hi hi (``swap``: hi_a lo_b, lo_a
    hi_b, hi hi, the keys kernel's, whose a is the rows kernel's b); 1: hi hi
    alone, which is the whole of a bf16 operand (exact in TF32; ``step``
    16, an m16n8k16 step)."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = ((ah, bh),)
    if passes == 3:
        terms = ((ah, bl), (al, bh), (ah, bh)) if swap else ((al, bh), (ah, bl), (ah, bh))
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], step):
        for x, y in terms:
            acc = add_toward_zero(acc, x[..., k0:k0 + step].double() @ y[..., k0:k0 + step, :].double())
    return acc


def _keys_scores(A, B_, f32, passes=0):
    """The keys kernel's S^T = A B^T (A its keys' K or V, B a query tile's Q
    or g): bf16 as :func:`_scores`; f32 with ``passes`` in split TF32 with
    the cross passes swapped (0: f32 products)."""
    return _tc_chain(A, B_.transpose(1, 2), passes, swap=True) if f32 and passes else _scores(A, B_)


def _tc_out(acc, p, M, f32, split=False, passes=0):
    """acc + P M as the tensor-core kernels' output steps add it: bf16, P as
    a bf16 operand (``split``: bf16(P) + bf16(P - bf16(P))); f32 with
    ``passes`` 3 (or 1) split TF32 into acc's chain, 0 f32 products."""
    if f32:
        return chain(p, M, acc=acc, passes=passes) if passes else acc + p @ M
    hi = _bf16(p)
    acc = acc + hi @ M
    return acc + _bf16(p - hi) @ M if split else acc


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
        return min(S, (t0 // BLK + 1) * BLK)
    if causal and mode == DROP:
        return min(S, t0 + BR)
    return S


def _masked(mode, s, ok, scale):
    if mode == FUSED:
        return torch.where(ok, s * scale, -1e30)
    if mode == DROP:
        return torch.where(ok, _bf16(s) * scale, -torch.inf)
    return s * scale + torch.where(ok, 0.0, ft.MASK_VALUE)


def fwd_emulation(mode, q, k, v, scale, lens=None, valid=None, causal=False, keep=None, rate=0.0,
                  split=True, passes=0):
    """wide_fwd_kernel's order: (out (B, T, H, D) in q's dtype, stats
    (2, B*H, T) for MODE 2).  ``split`` False rounds MODE 0's P once to
    bf16; in f32 ``passes`` 3 takes every product in split TF32 (1: one
    TF32 pass; 0: f32 products, the order of the tiles alone)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dt = q.dtype
    f32 = dt == torch.float32
    Q, K, V = _bh(q), _bh(k), _bh(v)
    ok_all = _key_ok(mode, B, H, T, S, lens, valid, causal)
    keep = None if keep is None else keep.reshape(B * H, T, S)
    c = ta.bf16_round(1.0 - rate)
    out = torch.zeros(B * H, T, D)
    stats = torch.zeros(2, B * H, T)
    one_block = mode == FLASH and S == BLK
    step = 2 * KEYS if mode == FLASH else KEYS
    for t0 in range(0, T, BR):
        r = slice(t0, min(t0 + BR, T))
        m = torch.full((B * H, r.stop - t0), -1e30 if mode == DROP else -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(B * H, r.stop - t0, D)
        for pass_ in ((0, 1) if mode == DROP else (1,)):
            for k0 in range(0, _k_end(mode, causal, t0, S), step):
                ks = slice(k0, min(k0 + step, S))
                x = _masked(mode, _tc_scores(Q[:, r], K[:, ks], f32, passes), ok_all[:, r, ks], scale)
                if mode == DROP and pass_ == 1:
                    e = torch.where(x == -torch.inf, 0.0, _ex2(x - m[..., None]))
                    wd = _bf16(e / l.clamp(min=1e-30)[..., None])
                    if rate > 0.0:
                        wd = torch.where(keep[:, r, ks], _bf16(wd / c), 0.0)
                    acc = _tc_out(acc, wd, V[:, ks], f32)
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
                acc = _tc_out(acc, p, V[:, ks], f32, split=mode == FUSED and split, passes=passes)
        mul = 1.0 if mode == DROP or one_block else (1.0 / l)[..., None]
        out[:, r] = acc * mul
        stats[0, :, r], stats[1, :, r] = m, l
    return _unbh(out, B, H, dt), stats


def bwd_emulation(mode, q, k, v, g, scale, valid, causal=False, keep=None, rate=0.0, out=None,
                  stats=None, passes=0, walks=("dk", "dv")):
    """wide_rows_kernel then wide_keys_kernel: (dq, dk, dv) in q's dtype.
    MODE 1 recomputes m, l and delta in the rows kernel; MODE 2 takes the
    forward's m and l and di = sum(out g).  In f32 ``passes`` as
    :func:`fwd_emulation`'s; ``walks`` the keys kernel's walks (("both",):
    dk and dv from one walk, the control of the kernel's two)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dt = q.dtype
    f32 = dt == torch.float32
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
        tiles = [slice(k0, min(k0 + KEYS, S)) for k0 in range(0, k_end, KEYS)]
        if mode == DROP:
            m = torch.full((B * H, r.stop - t0), -1e30)
            l, u = torch.zeros_like(m), torch.zeros_like(m)
            for ks in tiles:
                x = _masked(mode, _tc_scores(Q[:, r], K[:, ks], f32, passes), ok_all[:, r, ks], scale)
                dw = dropped(_tc_scores(G[:, r], V[:, ks], f32, passes),
                             None if keep is None else keep[:, r, ks])
                m_new = torch.maximum(m, x.amax(-1).clamp(min=-1e30))
                alpha = _ex2(m - m_new)
                e = torch.where(x == -torch.inf, 0.0, _ex2(x - m_new[..., None]))
                l = l * alpha + e.sum(-1)
                u = u * alpha + (e * dw).sum(-1)
                m = m_new
            delta = u / l.clamp(min=1e-30)
            st[0, :, r], st[1, :, r], st[2, :, r] = m, l, delta
            m, l, d = m, l.clamp(min=1e-30), delta
        else:
            m, l, d = st[0, :, r], st[1, :, r], st[2, :, r]
        acc = torch.zeros(B * H, r.stop - t0, D)
        for ks in tiles:
            x = _masked(mode, _tc_scores(Q[:, r], K[:, ks], f32, passes), ok_all[:, r, ks], scale)
            dp = _tc_scores(G[:, r], V[:, ks], f32, passes)
            if mode == DROP:
                w = torch.where(x == -torch.inf, 0.0, _ex2(x - m[..., None]) / l[..., None])
                dw = dropped(dp, None if keep is None else keep[:, r, ks])
                ds = _bf16(w * (dw - d[..., None]) * scale)
            else:
                p = _ex2(x - m[..., None]) * l[..., None]
                ds = ((dp - d[..., None]) * p * scale).to(dt).float()
            acc = _tc_out(acc, ds, K[:, ks], f32, passes=passes)
        dq[:, r] = acc
    if mode == DROP:
        st[1] = st[1].clamp(min=1e-30)
    okT = ok_all.transpose(1, 2)  # (BH, S, T)
    keepT = None if keep is None else keep.transpose(1, 2)
    for walk in walks:
        wk, wv = keys_emulation(mode, Q, K, V, G, st, okT, keepT, scale, c, rate, causal, dt, passes, walk)
        if walk != "dv":
            dk = wk
        if walk != "dk":
            dv = wv
    return tuple(_unbh(x, B, H, dt) for x in (dq, dk, dv))


def keys_emulation(mode, Q, K, V, G, st, okT, keepT, scale, c, rate, causal, dt, passes, walk):
    """wide_keys_kernel over (BH, ., D) f32 operands and the rows kernel's
    statistics ``st`` (m; max(l, 1e-30) or 1 / l; delta or di): each block
    of 64 keys walks the query tiles of 64 from its first (causal: MODE 1
    the tile of its first key, MODE 2 its 128-key block's first row), S^T in
    the rows kernel's order, w (MODE 1) or p (MODE 2) by its formulas.
    ``walk`` "dv" sums wd^T g or cast(p)^T g; "dk" takes (g V^T)^T and sums
    ds^T Q; "both" does both in one walk.  Returns (dk, dv) (BH, S, D), zeros
    for a walk not taken."""
    f32 = dt == torch.float32
    S, T = K.shape[1], Q.shape[1]
    dk, dv = torch.zeros_like(K), torch.zeros_like(K)
    for s0 in range(0, S, KEYS):
        kr = slice(s0, min(s0 + KEYS, S))
        q_begin = 0 if not causal else (s0 // BLK) * BLK if mode == FLASH else s0
        for t0 in range(q_begin, T, BR):
            ts = slice(t0, min(t0 + BR, T))
            m, l, d = (st[i, :, ts][:, None, :] for i in range(3))
            x = _masked(mode, _keys_scores(K[:, kr], Q[:, ts], f32, passes), okT[:, kr, ts], scale)
            kp = None if keepT is None else keepT[:, kr, ts]
            if mode == DROP:
                w = torch.where(x == -torch.inf, 0.0, _ex2(x - m) / l)
                wd = _bf16(w)
                if rate > 0.0:
                    wd = torch.where(kp, _bf16(wd / c), 0.0)
            else:
                w = _ex2(x - m) * l
                wd = w.to(dt).float()
            if walk != "dk":
                dv[:, kr] = _tc_out(dv[:, kr], wd, G[:, ts], f32, passes=passes)
            if walk != "dv":
                dp = _keys_scores(V[:, kr], G[:, ts], f32, passes)
                if mode == DROP:
                    dw = torch.where(kp, dp / c, 0.0) if rate > 0.0 else dp
                    ds = _bf16(w * (dw - d) * scale)
                else:
                    ds = ((dp - d) * w * scale).to(dt).float()
                dk[:, kr] = _tc_out(dk[:, kr], ds, Q[:, ts], f32, passes=passes)
    return dk, dv


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


def _excess(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 inside the bound."""
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def test_mode0_p_rounded_once_to_bf16_leaves_the_flash_tolerance():
    """Why the wide forward splits MODE 0's P into bf16 hi + lo: at head_dim
    256 with q x 4 (a peaked softmax) one bf16 rounding of P puts outputs
    outside phase 2f's atol + rtol of the f32-P twin, and the split keeps
    every output inside."""
    hd = 256
    g = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 512, 2, hd)).astype(np.float32) * s)
               .to(torch.bfloat16) for s in (4.0, 1.0, 1.0))
    sc = 1 / math.sqrt(hd)
    twin = attn.attention_reference(q, k, v)
    got, _ = fwd_emulation(FUSED, q, k, v, sc)
    assert _excess(got, twin, ATTN_ATOL, ATTN_RTOL) <= 1.0
    once, _ = fwd_emulation(FUSED, q, k, v, sc, split=False)
    assert _excess(once, twin, ATTN_ATOL, ATTN_RTOL) > 1.0


SPLIT_CASES = [  # (mode, head_dim, T, S, causal)
    (FUSED, 256, 200, 333, True), (FLASH, 192, 256, 256, True), (FLASH, 256, 128, 384, False)]


@pytest.mark.parametrize("mode,hd,T,S,causal", SPLIT_CASES,
                         ids=[f"mode{m}-hd{d}-T{t}-S{s}-{'causal' if c else 'full'}"
                              for m, d, t, s, c in SPLIT_CASES])
def test_split_tf32_wide_order_meets_f32_bounds(mode, hd, T, S, causal):
    """The wide f32 kernels' products in split TF32 (three passes into one
    chain each): the forward within F32_ATOL + F32_RTOL of the twin (MODE
    2's m and l too, as ``tests/test_torch_f32_split_tiles.py`` holds the
    narrow f32 forward's), the rows kernel's dq and the keys kernel's dk and
    dv within F32_REL."""
    q, k, v, g, valid = _inputs(hd, torch.float32, T=T, S=S)
    pq, pk, pv, pg = _padded(hd, q, k, v, g)
    sc = 1 / math.sqrt(hd)
    if mode == FUSED:
        lens = torch.tensor([0, 250], dtype=torch.int32)
        got, _ = fwd_emulation(FUSED, pq, pk, pv, sc, lens=lens, causal=causal, passes=3)
        want = attn.attention_reference(q, k, v, lens, causal)
        assert torch.allclose(_sliced(hd, got), want, atol=F32_ATOL, rtol=F32_RTOL)
        return
    got, stats = fwd_emulation(FLASH, pq, pk, pv, sc, valid=valid, causal=causal, passes=3)
    want, want_stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    assert torch.allclose(_sliced(hd, got), want, atol=F32_ATOL, rtol=F32_RTOL)
    assert torch.allclose(stats, want_stats, atol=F32_ATOL, rtol=F32_RTOL)
    grads = bwd_emulation(FLASH, pq, pk, pv, pg, sc, valid, causal, out=attn.pad_head(want, pq.shape[-1]),
                          stats=want_stats, passes=3)
    twins = ft.flash_train_bwd_reference(q, k, v, valid, want, want_stats, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, twins):
        assert _rel(_sliced(hd, a), b) < F32_REL, (name, _rel(_sliced(hd, a), b))


@pytest.mark.parametrize("kernel", ["forward", "rows", "keys"])
def test_one_tf32_pass_leaves_the_f32_bounds(kernel):
    """The control of the split-TF32 emulation: hi hi alone (one TF32 pass)
    moves MODE 2's output outside F32_ATOL + F32_RTOL of the twin, and dq
    (the rows kernel's) and dk (the keys kernel's) outside F32_REL, at
    head_dim 256."""
    hd = 256
    q, k, v, g, valid = _inputs(hd, torch.float32, T=128, S=256)
    sc = 1 / math.sqrt(hd)
    want, want_stats = ft.flash_train_fwd_reference(q, k, v, valid, False)
    if kernel == "forward":
        got, _ = fwd_emulation(FLASH, q, k, v, sc, valid=valid, passes=1)
        assert not torch.allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
        return
    at = 0 if kernel == "rows" else 1  # dq; dk
    got = bwd_emulation(FLASH, q, k, v, g, sc, valid, out=want, stats=want_stats, passes=1)[at]
    twin = ft.flash_train_bwd_reference(q, k, v, valid, want, want_stats, g, False)[at]
    assert _rel(got, twin) > F32_REL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_keys_order_scores_equal_rows_order(dtype):
    """The keys kernel's S^T = K Q^T, summed in the rows kernel's chunks and
    k steps, is the rows kernel's s = Q K^T transposed bit for bit: in bf16
    (exact products, m16n8k16 steps) and in split TF32 with the cross passes
    swapped.  Controls: the unswapped passes (lo_k hi_q first) move some
    f32 sums; the FMA pipes' order (one f32 FMA a head_dim, the earlier keys
    kernel's) moves some bf16 sums."""
    g = np.random.default_rng(11)
    q, k = (torch.from_numpy(g.standard_normal((2, 64, 256)).astype(np.float32)) for _ in range(2))
    if dtype == "bf16":
        q, k = _bf16(q), _bf16(k)
        rows = _tc_chain(q, k.transpose(1, 2), passes=1, step=16)
        assert torch.equal(_tc_chain(k, q.transpose(1, 2), passes=1, step=16), rows.transpose(1, 2))
        fma = torch.zeros(2, 64, 64)
        for d in range(q.shape[-1]):
            fma = (k[..., d, None].double() * q[:, None, :, d].double() + fma.double()).float()
        assert not torch.equal(fma, rows.transpose(1, 2))
        return
    rows = _tc_chain(q, k.transpose(1, 2))
    assert torch.equal(rows, chain(q, k.transpose(1, 2)))  # the emulations' rows order
    assert torch.equal(_tc_chain(k, q.transpose(1, 2), swap=True), rows.transpose(1, 2))
    assert not torch.equal(_tc_chain(k, q.transpose(1, 2)), rows.transpose(1, 2))


M32 = 0xFFFFFFFF
ROW_MUL, COL_MUL, BH_MUL = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D  # dropout_hash.cuh's


def _keep_words(words, bhg, x_base, y0, keys):
    """attention_wide.cu's ``keep_bits`` (keys False: a warp's 16 query rows
    from x_base, the key tile at y0) or ``keep_bits_t`` (keys True: its 16
    keys from x_base, the query tile at y0), one word a lane: (4 warps, 32
    lanes), and the lane's t and first fragment row."""
    s0, s1, thr = words
    lane = torch.arange(32)[None, :]
    x0 = x_base + 16 * torch.arange(4)[:, None] + lane // 4
    t = lane % 4
    bh_term = ta._mul32(torch.tensor(bhg), BH_MUL)
    bits = torch.zeros(4, 32, dtype=torch.int64)
    for e in range(4):
        x = x0 + 8 * (e >> 1)
        for j in range(8):
            y = y0 + 8 * j + 2 * t + (e & 1)
            row, col = (y, x) if keys else (x, y)
            h = ((((s0 + ta._mul32(row, ROW_MUL)) & M32) ^ ta._mul32(col, COL_MUL)) + bh_term) & M32
            h = ta._fmix32(ta._fmix32(h ^ s1) + s0 & M32)
            bits |= (h < thr).long() << (4 * j + e)
    return bits, t, x0


def _keep_map(bits, t, x0, x_base, y0, keys):
    """A 64 x 64 (query, key) map of the tile from the words' bits (-1 where
    no bit lands)."""
    out = torch.full((64, 64), -1, dtype=torch.int64)
    for e in range(4):
        for j in range(8):
            x = (x0 + 8 * (e >> 1) - x_base).expand(4, 32)
            y = (8 * j + 2 * t + (e & 1)).expand(4, 32)
            bit = bits >> (4 * j + e) & 1
            if keys:
                out[y, x] = bit
            else:
                out[x, y] = bit
    return out


def test_transposed_keep_bits_match_keep_bits():
    """MODE 1's keep bits in the keys kernel's orientation (fragment row =
    key, column = query; the hash at row = query, col = key) are
    ``keep_bits``' at the same (query, key), and ``dropout_mask_reference``'s,
    on a whole 64 x 64 tile at a shard's global (b, h)."""
    seed, rate, shard = (3, 9), 0.1, (1, 2, 5)
    B, H, T, S = 2, 2, 192, 320
    w = ta.seed_words(seed)
    words = (w[0] ^ w[2], w[1] ^ w[3], ta.keep_threshold(rate))
    mask = ta.dropout_mask_reference(seed, B, H, T, S, rate, None, *shard)
    b, h, q0, k0 = 1, 1, 128, 192
    bhg = (shard[0] + b) * shard[2] + shard[1] + h
    rows = _keep_map(*_keep_words(words, bhg, q0, k0, False), q0, k0, False)
    keys = _keep_map(*_keep_words(words, bhg, k0, q0, True), k0, q0, True)
    assert (rows >= 0).all() and (keys >= 0).all()
    assert torch.equal(keys, rows)
    assert torch.equal(keys.bool(), mask[b, h, q0:q0 + 64, k0:k0 + 64])


@pytest.mark.parametrize("mode,T,S", [(DROP, 200, 333), (DROP, 333, 200), (FLASH, 128, 384),
                                      (FLASH, 384, 256)])
def test_keys_kernel_two_walks_equal_one(mode, T, S):
    """The keys kernel's dk blocks and dv blocks (two walks, each with S^T
    recomputed) give the bits of one walk that takes both, causal, T != S,
    with a batch row that has no valid key (MODE 1: no weight; MODE 2: every
    visited key alike)."""
    hd = 192
    q, k, v, g, valid = _inputs(hd, torch.bfloat16, T=T, S=S)
    valid[1] = False
    sc = 1 / math.sqrt(hd)
    if mode == DROP:
        keep = ta.dropout_mask_reference((3, 9), 2, 2, T, S, 0.1, None, 1, 2, 5)
        kw = dict(keep=keep, rate=0.1)
    else:
        out, stats = ft.flash_train_fwd_reference(q, k, v, valid, True)
        kw = dict(out=out, stats=stats)
    two = bwd_emulation(mode, q, k, v, g, sc, valid, True, **kw)
    one = bwd_emulation(mode, q, k, v, g, sc, valid, True, walks=("both",), **kw)
    for name, a, b in zip(("dq", "dk", "dv"), two, one):
        assert torch.equal(a, b), name
    assert two[1].abs().sum() > 0 and two[2].abs().sum() > 0

"""The f32 flash-train backward kernels' arithmetic, emulated in plain torch
on the CPU, against JAX's library flash kernel and the port's twin; and the
kernels' rounding to TF32 on hand-picked bit patterns.

``flash_train_f32_dq_kernel`` and ``flash_train_f32_dkv_kernel``
(``ops/csrc/attention_f32.cu``) take every product in split TF32 on the
tensor cores and cannot run here, so ``bwd_split`` walks their arithmetic:

- each operand x of a product is split as hi = x rounded to TF32 (nearest,
  ties away from zero, as ``(bits + 0x1000) & 0xffffe000``) and lo = x - hi,
  which the tensor cores read as TF32 (its top 19 bits);
- a k8 step adds lo_a hi_b, hi_a lo_b and hi_a hi_b to one f32 accumulator
  in that order; each step's products are summed exactly and added to the
  accumulator rounded toward zero (a model of the tensor cores' own sums,
  which do not round to nearest);
- the chain runs over the whole reduction: head_dim for S = Q K^T and dP =
  g V^T, then the keys a query row visits (dq = ds K) or the rows that visit
  a key (dk = ds^T Q, dv = p^T g), when causal whole 128-blocks at or below
  the diagonal, as the kernels walk them;
- di = sum_d out g as the dq kernel takes it (HD / 4 lanes, four FMAs each,
  then a tree of lane shuffles); p = 2^((s scale + mask - m) log2 e) / l and
  ds = (dP - di) p scale in f32.

The emulation is held to JAX's library kernel in f32 (interpret mode) and to
the port's twin within ``chip_smoke.F32_REL`` (1e-4, JAX's tightest
kernel-to-twin gradient bound), the bound the card holds the kernels to; the
same emulation with one TF32 pass (hi hi alone) must fall outside it, so the
check can see a missing pass.

``attn_f32_fwd_kernel`` (the forward of both mask semantics) is emulated the
same way by ``fwd_split``: blocks of 64 query rows visiting the kernel's
key tiles (``kFwdBT`` keys, read from the source, as its ``n_keys``
gives them); S = Q K^T of each tile in split TF32 into a zeroed accumulator;
the scores scaled and masked in f32 (MODE 0: -inf past the key length or
the row, a row with no valid key weighing all keys alike; MODE 1: -0.7 f32
max added); each row's running max m, alpha = 2^((m - m_new) log2 e), p =
2^((s - m_new) log2 e), each lane's partial l = alpha l + its p in order,
summed over the quad at the end; o scaled by alpha, then P V added to o's
one chain.  MODE 0
is held to JAX's ``fused_attention`` and MODE 1 to the library flash
kernel's forward (both f32, interpret mode) within ``chip_smoke.F32_ATOL``
+ ``F32_RTOL``, MODE 1's m and l to the port's twin; one TF32 pass must
fall outside that bound.
"""

import math
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from chip_smoke import F32_ATOL, F32_REL, F32_RTOL
from smer_music_generation_tpu.ops.attention import fused_attention as jfused
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import flash_train as ft

BLK = 128
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MASK = -0.7 * float(torch.finfo(torch.float32).max)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The emulations take thousands of tiny float64 products, which a
    torch thread pool runs no faster and, when the other test workers hold
    the cores, much slower: one thread runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32, nearest with ties away from zero, as the
    kernels round it: half an ulp added to the bit pattern, the low 13 bits
    cut."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read an f32 register as TF32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_read(x - hi)


def add_toward_zero(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """acc + part (float64, exact) rounded to f32 toward zero."""
    exact = acc.double() + part
    y = exact.float()
    over = y.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def chain(a: torch.Tensor, b: torch.Tensor, acc=None, passes=3) -> torch.Tensor:
    """acc + a b (a (..., M, K), b (..., K, N), f32) in split TF32, k8 steps
    in order into one accumulator; ``passes`` 1 takes hi hi alone."""
    ah, al = split(a)
    bh, bl = split(b)
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = add_toward_zero(acc, x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double())
    return acc


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def lane_di(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_d o g (..., HD) as the dq kernel sums it: lane i of HD / 4 takes
    dims 4 i .. 4 i + 3 by FMAs, then xor shuffles add the lanes as a tree."""
    o4, g4 = (x.reshape(*x.shape[:-1], -1, 4) for x in (o, g))
    lanes = o4[..., 0] * g4[..., 0]
    for j in (1, 2, 3):
        lanes = fma(o4[..., j], g4[..., j], lanes)
    while lanes.shape[-1] > 1:
        lanes = lanes[..., 0::2] + lanes[..., 1::2]
    return lanes[..., 0]


def scores_p_ds(q, k, v, g, ok, m, rl, di, scale, passes):
    """p and ds of a (rows x keys) block from q, g rows and k, v keys."""
    s = chain(q, k.transpose(-1, -2), passes=passes)
    dp = chain(g, v.transpose(-1, -2), passes=passes)
    sv = fma(s, torch.tensor(scale), torch.where(ok, 0.0, MASK))
    p = torch.exp2((sv - m) * LOG2E) * rl
    return p, (dp - di) * p * torch.tensor(scale)


def _visible(valid_keys, keys, rows, causal):
    """Where the mask adds nothing to a (row, key) score: the key is valid
    and, when causal, not past the row."""
    return valid_keys & (keys[None, :] <= rows[:, None]) if causal else valid_keys


def bwd_split(q, k, v, valid, out, stats, g, causal, passes=3):
    """(dq, dk, dv) f32 in the split-TF32 kernels' arithmetic."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(D))
    heads = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731
    qh, kh, vh, gh, oh = (heads(x) for x in (q, k, v, g, out))
    m, l = (x.reshape(B, H, T, 1) for x in stats)
    rl = 1.0 / l
    di = lane_di(oh, gh)[..., None]
    okk = valid.to(torch.bool)[:, None, None, :]
    rows, keys = torch.arange(T), torch.arange(S)
    dq = torch.zeros(B, H, T, D)
    for qb in range(T // BLK):  # dq: the keys of the rows' 128-block and those below
        r = slice(qb * BLK, (qb + 1) * BLK)
        c = slice(0, min((qb + 1) * BLK, S) if causal else S)
        ok = _visible(okk[..., c], keys[c], rows[r], causal)
        _, ds = scores_p_ds(qh[:, :, r], kh[:, :, c], vh[:, :, c], gh[:, :, r], ok, m[:, :, r],
                            rl[:, :, r], di[:, :, r], scale, passes)
        dq[:, :, r] = chain(ds, kh[:, :, c], passes=passes)
    dk, dv = torch.zeros(B, H, S, D), torch.zeros(B, H, S, D)
    for kb in range(S // BLK):  # dk, dv: the rows from the keys' 128-block on
        c = slice(kb * BLK, (kb + 1) * BLK)
        r = slice(kb * BLK if causal else 0, T)
        ok = _visible(okk[..., c], keys[c], rows[r], causal)
        p, ds = scores_p_ds(qh[:, :, r], kh[:, :, c], vh[:, :, c], gh[:, :, r], ok, m[:, :, r],
                            rl[:, :, r], di[:, :, r], scale, passes)
        dv[:, :, c] = chain(p.transpose(-1, -2), gh[:, :, r], passes=passes)
        dk[:, :, c] = chain(ds.transpose(-1, -2), qh[:, :, r], passes=passes)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _jax_flash_grads(q, k, v, valid, g, causal):
    """JAX's library kernel as ``attend_flash_vjp`` calls it, in interpret
    mode, f32: (dq, dk, dv) as f32 arrays in the (B, L, H, D) layout."""
    B, T, _, D = q.shape
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))

    def f(q, k, v):
        t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal,
                                 sm_scale=1.0 / math.sqrt(D)))

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a.numpy(), jnp.float32) for a in (q, k, v)))
        grads = vjp(jnp.asarray(g.numpy(), jnp.float32))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in grads)


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30)).item()


def _inputs(T, S, D, seed, B=2, H=2):
    """Seeded f32 q, k, v, g and a key mask: ~10% of keys invalid, the first
    three of batch row 0 among them (its first causal rows have no key to
    attend), batch row 1 with no valid key at all."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((B, T, H, D), (B, S, H, D), (B, S, H, D), (B, T, H, D)))
    valid = rng.random((B, S)) >= 0.1
    valid[0, :3] = False
    valid[1] = False
    return q, k, v, g, torch.from_numpy(valid)


CASES = [(64, 128, 128, False), (64, 256, 256, True), (64, 128, 384, False),
         (128, 256, 128, False), (128, 256, 256, True)]


@pytest.mark.parametrize("D,T,S,causal", CASES,
                         ids=[f"hd{d}-T{t}-S{s}-{'causal' if c else 'full'}" for d, t, s, c in CASES])
def test_split_tf32_backward_meets_f32_bound_against_jax_and_twin(D, T, S, causal):
    q, k, v, g, valid = _inputs(T, S, D, seed=D + T + 3 * S + causal)
    out, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    got = bwd_split(q, k, v, valid, out, stats, g, causal)
    twin = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, g, causal)
    want = _jax_flash_grads(q, k, v, valid.numpy(), g, causal)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, twin, want):
        assert torch.isfinite(a).all()
        assert _rel(a, b) < F32_REL, (name, "twin", _rel(a, b))
        assert _rel(a, c) < F32_REL, (name, "jax", _rel(a, c))


@pytest.mark.parametrize("D,T,S,causal", [(64, 128, 128, False), (128, 256, 256, True)],
                         ids=["hd64-T128-S128-full", "hd128-T256-S256-causal"])
def test_one_tf32_pass_misses_the_f32_bound(D, T, S, causal):
    """The control: hi hi alone reads ~3e-4 from the twin, outside F32_REL."""
    q, k, v, g, valid = _inputs(T, S, D, seed=D + T + 3 * S + causal)
    out, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    got = bwd_split(q, k, v, valid, out, stats, g, causal, passes=1)
    twin = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, g, causal)
    assert max(_rel(a, b) for a, b in zip(got, twin)) > F32_REL


# ----------------------------------------------------------------------
# the forward, attn_f32_fwd_kernel
# ----------------------------------------------------------------------
_SRC = (Path(__file__).resolve().parents[1] / "smer_music_generation_tpu_torch" / "ops" / "csrc"
        / "attention_f32.cu").read_text()
FWD_BT = int(re.search(r"constexpr int kFwdBT = (\d+);", _SRC).group(1))
ROWS = 64  # query rows a block


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (..., 4, C / 4): lane t's columns of a C-wide tile in its
    order, the C fragments' 8 j + 2 t and 8 j + 2 t + 1, j = 0, 1, ..."""
    c = x.shape[-1]
    idx = torch.tensor([[8 * j + 2 * t + e for j in range(c // 8) for e in (0, 1)] for t in range(4)])
    return x[..., idx]


def fwd_split(q, k, v, keys, causal, mode, passes=3):
    """(out (B, T, H, D), m, l (B, H, T)) f32 in attn_f32_fwd_kernel's
    arithmetic; ``keys`` the key lengths (B,) or None (MODE 0) or the
    validity (B, S) (MODE 1)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    out = torch.zeros(B, H, T, D)
    m_out, l_out = torch.zeros(B, H, T), torch.zeros(B, H, T)
    for b in range(B):
        n_valid = S if keys is None or mode == 1 else min(int(keys[b]), S)
        uniform = mode == 0 and n_valid <= 0
        clip = mode == 0 and causal and not uniform
        for t0 in range(0, T, ROWS):
            rs = slice(t0, min(t0 + ROWS, T))
            r = torch.arange(rs.start, rs.stop)
            if mode == 0:
                n_keys = min(n_valid, t0 + ROWS) if clip else (S if uniform else n_valid)
            else:
                n_keys = min((t0 // BLK + 1) * BLK, S) if causal else S
            o = torch.zeros(H, len(r), D)
            m = torch.full((H, len(r)), -1e30 if mode == 0 else -math.inf)
            lanes = torch.zeros(H, len(r), 4)
            for k0 in range(0, n_keys, FWD_BT):
                c = torch.arange(k0, k0 + FWD_BT)
                kt, vt = (torch.zeros(H, FWD_BT, D) for _ in range(2))
                inside = c < S
                kt[:, inside], vt[:, inside] = kh[b][:, c[inside]], vh[b][:, c[inside]]
                s = chain(qh[b][:, rs], kt.transpose(-1, -2), passes=passes)
                if mode == 0:
                    masked = (c[None, :] >= n_valid) | (clip & (c[None, :] > r[:, None]))
                    s = torch.where((c[None, :] >= S) | (masked & (not uniform)), -math.inf,
                                    torch.zeros_like(s) if uniform else s * scale)
                else:
                    keep = keys[b][c].bool()[None, :] & ~(causal & (c[None, :] > r[:, None]))
                    s = fma(s, scale, torch.where(keep, 0.0, MASK))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - m_new) * LOG2E)
                p = torch.exp2((s - m_new[..., None]) * LOG2E)
                part, pl = torch.zeros_like(lanes), _lanes(p)
                for i in range(FWD_BT // 4):
                    part = part + pl[..., i]
                lanes = fma(alpha[..., None], lanes, part)
                m = m_new
                o = chain(p, vt, acc=o * alpha[..., None], passes=passes)
            l = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
            inv = 1.0 / (l.clamp(min=1e-30) if mode == 0 else l)
            out[b, :, rs] = o * inv[..., None]
            m_out[b, :, rs], l_out[b, :, rs] = m, l
    return out.permute(0, 2, 1, 3), m_out, l_out


def _jax_flash_out(q, k, v, valid, causal):
    """The library flash kernel's forward in f32, interpret mode, as
    ``attend_flash_vjp`` calls it: (B, T, H, D)."""
    B, T, _, D = q.shape
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))
    t = lambda a: jnp.asarray(a.numpy(), jnp.float32).transpose(0, 2, 1, 3)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal, sm_scale=1.0 / math.sqrt(D))
    return torch.from_numpy(np.asarray(o, np.float32)).permute(0, 2, 1, 3)


def _jax_fused_out(q, k, v, lens, causal):
    """JAX's ``fused_attention`` in f32, interpret mode."""
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    o = jfused(*(jnp.asarray(a.numpy(), jnp.float32) for a in (q, k, v)), kv_valid_len=jl,
               causal=causal, blk_q=32, blk_kv=32, interpret=True)
    return torch.from_numpy(np.asarray(o, np.float32))


def _within_f32(a, b) -> bool:
    return torch.allclose(a, b, atol=F32_ATOL, rtol=F32_RTOL)


FWD0_CASES = [  # (head_dim, B, T, S, key lengths, causal): T, S not multiples of the tiles
    (64, 2, 96, 120, [120, 70], False),
    (64, 3, 100, 96, [96, 0, 1], True),  # a batch row with no valid key (JAX pads S to 32s)
    (128, 2, 70, 77, [77, 40], True),
]


@pytest.mark.parametrize("D,B,T,S,lens,causal", FWD0_CASES,
                         ids=[f"hd{d}-T{t}-S{s}-{'causal' if c else 'full'}"
                              for d, _, t, s, _, c in FWD0_CASES])
def test_split_tf32_forward_mode0_meets_f32_bound_against_jax_and_twin(D, B, T, S, lens, causal):
    rng = np.random.default_rng(D + T + S)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((B, T, 2, D), (B, S, 2, D), (B, S, 2, D)))
    kl = torch.tensor(lens, dtype=torch.int32)
    got, _, _ = fwd_split(q, k, v, kl, causal, mode=0)
    assert torch.isfinite(got).all()
    assert _within_f32(got, attn.attention_reference(q, k, v, kl, causal))
    assert _within_f32(got, _jax_fused_out(q, k, v, lens, causal))


FWD1_CASES = [(64, 128, 256, False), (64, 256, 256, True), (128, 256, 128, False),
              (128, 128, 128, True)]


@pytest.mark.parametrize("D,T,S,causal", FWD1_CASES,
                         ids=[f"hd{d}-T{t}-S{s}-{'causal' if c else 'full'}" for d, t, s, c in FWD1_CASES])
def test_split_tf32_forward_mode1_meets_f32_bound_against_jax_and_twin(D, T, S, causal):
    q, k, v, _, valid = _inputs(T, S, D, seed=7 * D + T + S + causal)
    got, m, l = fwd_split(q, k, v, valid, causal, mode=1)
    want, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    assert torch.isfinite(got).all()
    assert _within_f32(got, want)
    assert _within_f32(got, _jax_flash_out(q, k, v, valid.numpy(), causal))
    B, _, H, _ = q.shape
    for got_stat, want_stat in zip((m, l), stats):
        assert torch.allclose(got_stat.reshape(B * H, T), want_stat, atol=F32_ATOL, rtol=F32_RTOL)


def test_one_tf32_pass_forward_misses_the_f32_bound():
    """The control: hi hi alone moves the output outside atol + rtol."""
    q, k, v, _, valid = _inputs(128, 256, 64, seed=11)
    got, _, _ = fwd_split(q, k, v, valid, False, mode=1, passes=1)
    assert not _within_f32(got, ft.flash_train_fwd_reference(q, k, v, valid, False)[0])


def _bits(x: int) -> torch.Tensor:
    return torch.from_numpy(np.array([x], dtype=np.uint32).view(np.float32))


def _exact(t: torch.Tensor) -> Fraction:
    return Fraction(float(t.item()))


def _nearest_tf32(bits: int) -> int:
    """The TF32 value nearest the f32 of ``bits``, ties away from zero, found
    by exact rationals between its two TF32 neighbours."""
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    down, up = mag & ~0x1FFF, (mag & ~0x1FFF) + 0x2000
    x, lo, hi = (abs(_exact(_bits(b))) for b in (mag, down, up))
    return sign | (up if hi - x <= x - lo else down)


PATTERNS = {
    "one": 0x3F800000, "tie": 0x3F801000, "below_tie": 0x3F800FFF, "above_tie": 0x3F801001,
    "odd_tie": 0x3F803000, "negative_tie": 0xBF801000, "negative_below_tie": 0xBF800FFF,
    "carry_into_exponent": 0x3FFFFFFF, "smallest_subnormal": 0x00000001,
    "subnormal_tie": 0x00001000, "negative_subnormal_tie": 0x80001000,
    "subnormal_to_normal": 0x007FF000, "up_to_largest_tf32": 0x7F7FD800, "zero": 0x00000000,
    "negative_zero": 0x80000000, "random_normal": 0x41C8A5F3,
}


@pytest.mark.parametrize("bits", list(PATTERNS.values()), ids=list(PATTERNS))
def test_tf32_rounding_and_split_on_hand_picked_bits(bits):
    x = _bits(bits)
    hi, lo = split(x)
    got = int(hi.view(torch.int32).item()) & 0xFFFFFFFF
    assert got == _nearest_tf32(bits), (hex(got), hex(_nearest_tf32(bits)))
    # lo = x - hi is exact in f32, so hi + lo is x, and lo is at most half a
    # TF32 ulp of x
    rest = x - hi
    assert _exact(hi) + _exact(rest) == _exact(x)
    assert abs(_exact(rest)) <= abs(_exact(x)) / 2 ** 11 or abs(_exact(x)) < 2.0 ** -126
    # the tensor cores read lo's top 19 bits
    assert (int(lo.view(torch.int32).item()) & 0x1FFF) == 0

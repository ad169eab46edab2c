"""The tile arithmetic of the tensor-core attention kernels, emulated in
plain torch on the CPU, against the JAX kernels and the port's twins.

``flash_fwd_kernel`` (``ops/csrc/attention.cu``), ``train_fwd_kernel`` and
the backward pair ``train_bwd_rows_kernel`` + ``train_bwd_keys_kernel``
(``ops/csrc/train_attention.cu``) cannot run here, so these emulations
repeat their rounding sequence step by step:

- the flash forward: 64-key tiles in order, the scores as f32 sums of bf16
  products, -inf on masked keys and keys past S (0 on every key of a batch
  row with no valid key, which weighs all keys alike), an online max m of
  the scores times scale * log2(e), p = 2^(s scale log2(e) - m), a sum l and
  an f32 accumulator, and P applied to V as bf16(P) plus bf16(P - bf16(P)),
  both products summed in f32; the output divided by max(l, 1e-30), rounded
  to bf16;
- the train forward: the scores as f32 sums over head_dim in mma's k16
  chunk order (chunks 0, 1, 2, 3, each an f32 dot), rounded to bf16, -inf on
  masked keys; pass 1 over 64-key tiles keeps a running max m of them and a
  sum l of e = 2^((s - m) log2(e) / 8), rescaled as m grows; pass 2
  recomputes e, w = e / max(l, 1e-30), bf16, the keep mask and
  bf16(w16 / bf16(1 - rate)), and sums wd V in f32;
- the train backward: the scores as the train forward's, g . v in the same
  k16 chunk order, dw = keep ? (g . v) / bf16(1 - rate) : 0; the rows
  kernel's pass 1 over 64-key tiles keeps the forward's m and l and a sum u
  of e dw rescaled with l, so delta = u / max(l, 1e-30) (online, where JAX
  sums w dw over the whole row); w exact from the final m and l; ds =
  bf16(w (dw - delta) / 8); dq as bf16(ds) K summed in f32 tile after
  64-key tile; the keys kernel's dk = ds^T Q and dv = wd^T g summed in f32
  tile after 64-row query tile, wd = keep ? bf16(bf16(w) / bf16(1 - rate))
  : 0.

The kernels evaluate s x - m with one FMA where these take two roundings;
that moves an exponent by a few f32 ulps, far below the tolerances.
Tiles a kernel skips (past a block's last attendable key) contribute exact
zeros in both kernels, so the emulations walk every tile.

Each emulation is held against the JAX kernel in interpret mode (as
``tests/test_torch_attention.py`` and ``tests/test_torch_train_attention.py``
run it) and against the port's twin, with chip_smoke's tolerances (the ones
the card holds each kernel to against its twin): ``ATTN_ATOL`` 1e-3 +
``ATTN_RTOL`` 2^-7 for the flash forward, ``TA_ATOL`` 1e-2 + ``TA_RTOL``
2^-7 for the train forward, ``TA_REL`` (relative norm: dq and dk 0.02, dv
1e-3) for the train backward, whose online delta is also held to JAX's
exact sum within f32 rounding.  Inputs are made with numpy from a seed, q
scaled by 1, 4 and 16 so that the softmax runs from flat to as peaked as a
trained encoder's.  One case pins why the flash kernel splits P: P rounded
once to bf16 leaves that tolerance at q x 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_ATOL, ATTN_RTOL, TA_ATOL, TA_CASES, TA_REL, TA_RTOL
from smer_music_generation_tpu.ops.attention import fused_attention as jfused
from smer_music_generation_tpu.ops import train_attention as jta
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import train_attention as ta

KEY_TILE = 64
MASKED = -1e30
LOG2E = 1.4426950408889634
SCALES = (1.0, 4.0, 16.0)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _qkv(B, T, S, H, scale, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, 64)) * scale
    k, v = (rng.standard_normal((B, S, H, 64)) for _ in range(2))
    return _bf16(q), _bf16(k), _bf16(v)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, 64) -> (B, H, L, 64) in f32."""
    return x.float().permute(0, 2, 1, 3)


def _excess(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 inside the tolerance."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def flash_tiles(q, k, v, lens=None, causal=False, split=True) -> torch.Tensor:
    """``flash_fwd_kernel``'s arithmetic over (B, T|S, H, 64) bf16 tensors;
    ``split=False`` rounds P once to bf16 instead."""
    B, T, H, D = q.shape
    S = k.shape[1]
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    n_valid = torch.tensor(lens if lens is not None else [S] * B).clamp(max=S)
    uniform = (n_valid <= 0)[:, None, None, None]  # every key masked: all S weigh alike
    sl2 = torch.tensor((1.0 / np.sqrt(D)) * LOG2E, dtype=torch.float32)
    rows = torch.arange(T)[:, None]
    m = torch.full((B, H, T), MASKED)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, D)
    for k0 in range(0, S, KEY_TILE):
        cols = torch.arange(k0, min(S, k0 + KEY_TILE))
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        masked = (cols[None, :] >= n_valid[:, None])[:, None, None, :]
        if causal:
            masked = masked | (cols[None, :] > rows)[None, None]
        s = torch.where(uniform, torch.tensor(0.0), torch.where(masked, -torch.inf, s))
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, cols]
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, cols]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


SL2 = torch.tensor(LOG2E / 8, dtype=torch.float32)  # log2(e) times the scale 1/8


def _k16_sums(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x y^T over head_dim as mma.sync sums it: an f32 dot per k16 chunk,
    the chunks added in order 0, 1, 2, 3."""
    out = torch.zeros(*x.shape[:-1], y.shape[-2])
    for c0 in range(0, x.shape[-1], 16):
        out = out + x[..., c0:c0 + 16] @ y[..., c0:c0 + 16].transpose(-1, -2)
    return out


def _masked_scores(qf, kf, valid, causal):
    """bf16(q . k) (the 1/8 lives in SL2), -inf where the key is invalid or
    past the row when causal: the one score sequence of the train kernels."""
    B, H, T, _ = qf.shape
    S = kf.shape[2]
    s = _k16_sums(qf, kf).to(torch.bfloat16).float()
    mask = valid.bool()[:, None, None, :].expand(B, H, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool).tril()[None, None]
    return torch.where(mask, s, -torch.inf)


def _pass1(s, dw=None):
    """Pass 1 over 64-key tiles: the running max m and sum l of e = 2^(s SL2
    - m SL2), rescaled as m grows; with ``dw``, also the running sum u of
    e dw under the same rescaling."""
    m = torch.full(s.shape[:-1], MASKED)
    l = torch.zeros(s.shape[:-1])
    u = torch.zeros(s.shape[:-1])
    for k0 in range(0, s.shape[-1], KEY_TILE):
        st = s[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp2((m - m_new) * SL2)
        e = torch.exp2(st * SL2 - (m_new * SL2)[..., None])
        l = l * alpha + e.sum(-1)
        if dw is not None:
            u = u * alpha + (e * dw[..., k0:k0 + KEY_TILE]).sum(-1)
        m = m_new
    return m, l, u


def train_fwd_tiles(q, k, v, valid, keep, rate: float, causal=False) -> torch.Tensor:
    """``train_fwd_kernel``'s arithmetic: (B, T|S, H, 64) bf16 tensors,
    ``valid`` (B, S) bool, ``keep`` (B, H, T, S) bool or None at rate 0."""
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    s = _masked_scores(qf, kf, valid, causal)
    # pass 1: the running max and the sum of the exponentials
    m, l, _ = _pass1(s)
    # pass 2: the weights from the final m and l, dropped, times V
    e = torch.exp2(s * SL2 - (m * SL2)[..., None])
    w16 = (e / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
    if rate > 0.0:
        c = ta.bf16_round(1.0 - rate)
        w16 = torch.where(keep, (w16.float() / c).to(torch.bfloat16), torch.zeros_like(w16))
    out = w16.float() @ vf
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def train_bwd_tiles(q, k, v, g, valid, keep, rate: float, causal=False):
    """``train_bwd_rows_kernel``'s and ``train_bwd_keys_kernel``'s
    arithmetic: (B, T|S, H, 64) bf16 tensors and the bf16 cotangent ``g``,
    ``valid`` (B, S) bool, ``keep`` (B, H, T, S) bool or None at rate 0.
    Returns ((dq, dk, dv) in bf16, delta (B, H, T) f32, the exact f32
    weights w (B, H, T, S) and dw)."""
    qf, kf, vf, gf = _heads(q), _heads(k), _heads(v), _heads(g)
    T, S = qf.shape[2], kf.shape[2]
    s = _masked_scores(qf, kf, valid, causal)
    dw = _k16_sums(gf, vf)  # g . v, by the same mma sequence as the scores
    c = ta.bf16_round(1.0 - rate)
    if rate > 0.0:
        dw = torch.where(keep, dw / c, torch.zeros(()))
    # rows kernel, pass 1: m, l and u = sum e dw online; delta = u / l
    m, l, u = _pass1(s, dw)
    den = l.clamp(min=1e-30)
    delta = u / den
    # pass 2 (and the keys kernel, from the same m, l, delta): w exact, ds
    w = torch.exp2(s * SL2 - (m * SL2)[..., None]) / den[..., None]
    ds16 = ((w * (dw - delta[..., None])) * 0.125).to(torch.bfloat16).float()
    dq = torch.zeros_like(qf)
    for k0 in range(0, S, KEY_TILE):  # rows kernel: key tiles in order
        dq = dq + ds16[..., k0:k0 + KEY_TILE] @ kf[..., k0:k0 + KEY_TILE, :]
    wd16 = w.to(torch.bfloat16)
    if rate > 0.0:
        wd16 = torch.where(keep, (wd16.float() / c).to(torch.bfloat16), torch.zeros_like(wd16))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, T, KEY_TILE):  # keys kernel: 64-row query tiles in order
        rows = slice(r0, r0 + KEY_TILE)
        dv = dv + wd16[..., rows, :].float().transpose(-1, -2) @ gf[..., rows, :]
        dk = dk + ds16[..., rows, :].transpose(-1, -2) @ qf[..., rows, :]
    grads = tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16) for x in (dq, dk, dv))
    return grads, delta, w, dw


FLASH_CASES = [  # (B, T, S, key lengths or None, causal)
    (2, 64, 64, None, False),
    (3, 100, 77, [77, 0, 1], False),
    (3, 100, 77, [77, 0, 1], True),
    (2, 130, 200, [200, 150], True),
]


@pytest.mark.parametrize("scale", SCALES, ids=[f"q{s:g}" for s in SCALES])
@pytest.mark.parametrize("B,T,S,lens,causal", FLASH_CASES,
                         ids=[f"B{b}-T{t}-S{s}-{'lens' if n else 'full'}-{'causal' if c else 'bidir'}"
                              for b, t, s, n, c in FLASH_CASES])
def test_flash_tiles_match_jax_kernel_and_twin(B, T, S, lens, causal, scale):
    q, k, v = _qkv(B, T, S, H=2, scale=scale, seed=T + S + int(scale))
    got = flash_tiles(q, k, v, lens, causal)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    twin = attn.fused_attention(q, k, v, tl, causal)  # CPU tensors: the twin
    assert _excess(got, twin, ATTN_ATOL, ATTN_RTOL) <= 1.0
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    want = jfused(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                  kv_valid_len=jl, causal=causal, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    # a sequence with no valid key: the twin weighs all S keys alike (JAX's
    # reference), the Pallas kernel all S padded to its block; not compared
    rows = torch.ones(B, dtype=torch.bool) if lens is None else torch.tensor(lens) > 0
    assert _excess(got[rows], want[rows], ATTN_ATOL, ATTN_RTOL) <= 1.0


def test_flash_row_with_no_valid_key_weighs_all_keys_alike():
    q, k, v = _qkv(2, 40, 70, H=2, scale=4.0, seed=1)
    for causal in (False, True):
        got = flash_tiles(q, k, v, [0, 70], causal)
        mean = v[0].float().mean(dim=0)  # (H, 64)
        assert _excess(got[0], mean[None].expand(40, 2, 64), ATTN_ATOL, ATTN_RTOL) <= 1.0


def test_p_rounded_once_to_bf16_leaves_the_flash_tolerance():
    """Why the flash kernel splits P into bf16 hi + lo: at q x 4 (a peaked
    softmax) one bf16 rounding of P puts outputs outside atol 1e-3 + rtol
    2^-7 of the f32-P twin, and the split keeps every output inside."""
    q, k, v = _qkv(1, 512, 512, H=2, scale=4.0, seed=0)
    twin = attn.attention_reference(q, k, v)
    assert _excess(flash_tiles(q, k, v, split=True), twin, ATTN_ATOL, ATTN_RTOL) <= 1.0
    assert _excess(flash_tiles(q, k, v, split=False), twin, ATTN_ATOL, ATTN_RTOL) > 1.0


TRAIN_CASES = [  # (T, S, causal, rate)
    (128, 256, False, 0.1),
    (200, 333, False, 0.1),
    (256, 256, True, 0.1),
    (130, 130, True, 0.0),
]


@pytest.mark.parametrize("scale", SCALES, ids=[f"q{s:g}" for s in SCALES])
@pytest.mark.parametrize("T,S,causal,rate", TRAIN_CASES,
                         ids=[f"T{t}-S{s}-{'causal' if c else 'bidir'}-rate{r:g}"
                              for t, s, c, r in TRAIN_CASES])
def test_train_fwd_tiles_match_jax_kernel_and_twin(T, S, causal, rate, scale):
    B, H = 2, 2
    q, k, v = _qkv(B, T, S, H=H, scale=scale, seed=T + S + int(scale))
    rng = np.random.default_rng(T * S)
    valid = rng.random((B, S)) < 0.9
    valid[1] = False  # one batch row with no valid key
    key = jax.random.PRNGKey(5)
    keep = ta.dropout_mask_reference(np.asarray(key), B, H, T, S, rate) if rate > 0 else None
    got = train_fwd_tiles(q, k, v, torch.from_numpy(valid), keep, rate, causal)
    assert (got[1] == 0).all()
    twin = ta.dropout_attention_fwd_reference(q, k, v, torch.from_numpy(valid), np.asarray(key),
                                              rate, causal)
    assert _excess(got, twin, TA_ATOL, TA_RTOL) <= 1.0
    blk_q = T if T % jta.DEFAULT_BLK_Q else jta.DEFAULT_BLK_Q  # the JAX kernel tiles T evenly
    want = jta.fused_dropout_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                                       jnp.asarray(valid), key, rate, causal, blk_q)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _excess(got, want, TA_ATOL, TA_RTOL) <= 1.0


BWD_CASES = [  # (T, S, causal): the encoder's, the decoder's self and cross attention
    (640, 640, False),
    (384, 384, True),
    (384, 640, False),
]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("scale", SCALES, ids=[f"q{s:g}" for s in SCALES])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("T,S,causal", BWD_CASES,
                         ids=[f"T{t}-S{s}-{'causal' if c else 'bidir'}" for t, s, c in BWD_CASES])
def test_train_bwd_tiles_match_jax_vjp_and_twin(T, S, causal, rate, scale):
    B, H = 2, 2
    q, k, v = _qkv(B, T, S, H=H, scale=scale, seed=3 * T + S + int(scale))
    rng = np.random.default_rng(T + S)
    g = _bf16(rng.standard_normal((B, T, H, 64)))
    valid = rng.random((B, S)) < 0.9
    valid[0, S - 45:] = False  # a ragged key length, besides the holes
    valid[1] = False  # one batch row with no valid key
    key = jax.random.PRNGKey(9)
    keep = ta.dropout_mask_reference(np.asarray(key), B, H, T, S, rate) if rate > 0 else None
    got, delta, w, dw = train_bwd_tiles(q, k, v, g, torch.from_numpy(valid), keep, rate, causal)
    # the online delta is JAX's sum_s w dw up to f32 rounding: the sums run
    # in other orders, and the online one takes each e as 2^(s SL2 - m' SL2)
    # times the rescaling factors, whose f32 exponents round apart from the
    # final one's (more so as the scores grow); within 2^-16 of the sum of
    # |w dw| (at most 3.9e-6 of it over these cases, at q x 16)
    exact = (w * dw).sum(-1)
    assert ((delta - exact).abs() <= 2 ** -16 * (w * dw).abs().sum(-1)).all()
    for grad in got:  # the batch row with no valid key: gradients exactly 0
        assert (grad[1] == 0).all()
    twin = ta.dropout_attention_bwd_reference(q, k, v, torch.from_numpy(valid), np.asarray(key), g,
                                              rate, causal)
    names = ("dq", "dk", "dv")
    for name, a, b in zip(names, got, twin):
        assert _rel(a, b) < TA_REL[name], (name, _rel(a, b))
    jg = jnp.asarray(g.float().numpy())

    def jloss(a, b, c):
        out = jta.fused_dropout_attention(a, b, c, jnp.asarray(valid), key, rate, causal)
        return (out.astype(jnp.float32) * jg).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                                for x in (q, k, v)))
    for name, a, b in zip(names, got, want):
        b = torch.from_numpy(np.array(b.astype(jnp.float32)))
        assert _rel(a, b) < TA_REL[name], (name, _rel(a, b))


def _dv(w, keep, rate, gf):
    """dv = wd^T g in f32 from f32 weights w (B, H, T, S), as both kernels
    and the twin take it: wd = keep ? bf16(bf16(w) / bf16(1 - rate)) : 0."""
    wd16 = w.to(torch.bfloat16)
    if rate > 0.0:
        c = ta.bf16_round(1.0 - rate)
        wd16 = torch.where(keep, (wd16.float() / c).to(torch.bfloat16), torch.zeros_like(wd16))
    return (wd16.float().transpose(-1, -2) @ gf).permute(0, 2, 1, 3).to(torch.bfloat16)


def test_dv_moves_with_the_last_bits_of_w():
    """Why the kernels' dv is held to TA_REL["dv"] = 1e-3 of the twin and
    not to JAX's 1e-4 (tests/test_ops.py:654, where JAX's kernel computes
    bit-equal weights to its twin): dv = bf16(w)^T g, and a w that differs
    from the twin's in its last f32 bits rounds to the neighbouring bf16
    value often enough to move dv by ~1e-4 of its norm.  At phase 2g's
    six shapes (B=2, H=8 here, rate 0.1, ~10% of keys invalid, one batch
    row with no valid key): the twin's own w gives the twin's dv up to the
    order of the f32 sums; the keys kernel's w with an exact exp2 and an
    exact division (``train_bwd_tiles``: the online l) leaves 1e-4 on at
    least one shape, and so does the twin's own formula exp((s - m) / 8) /
    sum e with the sum taken in 64-key tiles.  So no accurate exp2 brings
    the kernel within 1e-4: the step at fault is the bf16 rounding of w,
    which turns any difference in how w is computed, the order of l's
    sum included, into whole bf16 ulps."""
    B, H, rate = 2, 8, 0.1
    key = jax.random.PRNGKey(9)
    worst = {"twin w": 0.0, "exact exp2, online l": 0.0, "exp(s - m), l in tiles": 0.0}
    for T, S, causal in TA_CASES:
        q, k, v = _qkv(B, T, S, H=H, scale=1.0, seed=3 * T + S)
        rng = np.random.default_rng(T + S)
        g = _bf16(rng.standard_normal((B, T, H, 64)))
        valid = rng.random((B, S)) >= 0.1
        valid[1] = False
        vt = torch.from_numpy(valid)
        keep = ta.dropout_mask_reference(np.asarray(key), B, H, T, S, rate)
        twin = ta.dropout_attention_bwd_reference(q, k, v, vt, np.asarray(key), g, rate, causal)[2]
        _, _, w, _ = train_bwd_tiles(q, k, v, g, vt, keep, rate, causal)
        s = _masked_scores(_heads(q), _heads(k), vt, causal)
        m = s.amax(-1, keepdim=True)
        e = torch.exp((s - m) * 0.125)
        l = sum(e[..., k0:k0 + KEY_TILE].sum(-1) for k0 in range(0, S, KEY_TILE))
        variants = {
            "twin w": ta._weights(q, k, vt.to(torch.int32), causal)[0],
            "exact exp2, online l": w,
            "exp(s - m), l in tiles": torch.nan_to_num(e / l.clamp(min=1e-30)[..., None]),
        }
        rels = {name: _rel(_dv(wv, keep, rate, _heads(g)), twin) for name, wv in variants.items()}
        print(f"T={T} S={S} causal={causal}: dv relative norm to the twin " +
              ", ".join(f"{n} {r:.3e}" for n, r in rels.items()))
        for name, r in rels.items():
            worst[name] = max(worst[name], r)
    assert worst["twin w"] < 1e-6
    assert 1e-4 < worst["exact exp2, online l"] < TA_REL["dv"]
    assert 1e-4 < worst["exp(s - m), l in tiles"] < TA_REL["dv"]

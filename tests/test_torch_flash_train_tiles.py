"""The flash-train backward kernels' order of work, emulated in plain torch
on the CPU, against the port's twin and JAX's library kernel; the wrapper's
refusals; and the model's gate on the head_dim and dtype the CUDA attention
kernels take.

``flash_train_dq_kernel`` and ``flash_train_dkv_kernel``
(``ops/csrc/flash_train.cu``) cannot run here, so ``bwd_tiles`` walks their
order step by step:

- di = sum_d out g per row as the dq kernel takes it: four lanes each sum
  16 dims in order (one FMA a dim, exact products of bf16 values), the quad
  adds the four as (0 + 1) + (2 + 3);
- dq: a block per 128 query rows; 64-key tiles in order, when causal only
  those of the 128-key blocks at or below the rows' block (whole tiles:
  the library's ``below_or_on_diag``), the additive mask on the diagonal
  block; p = 2^((s - m) log2 e) (1 / l), ds = bf16((dp - di) p / 8), dq +=
  ds K tile after tile in f32;
- dk, dv: a block per 128 keys; 64-row query tiles in order from the keys'
  block when causal; each tile's dv = bf16(p)^T g summed apart and added to
  the running dv in f32, dk += bf16(ds)^T Q.

A tile that the kernels skip contributes nothing in the twin either (p is
0 there), so the emulation is held to the twin within ``TA_REL``, the
bounds the card holds the kernels to (``chip_smoke.py``), dv also within
JAX's own kernel-to-twin bound of 1e-4 (``tests/test_ops.py:654``: the same
bf16 products, summed in another f32 order), and to JAX's
VJP (interpret mode) within the bf16 bounds of
``tests/test_torch_flash_train.py`` (2e-2 for the gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from chip_smoke import TA_REL
from smer_music_generation_tpu_torch.models import transformer as tr
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta

BLK, TILE = 128, 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MASK = torch.tensor(-0.7 * float(torch.finfo(torch.float32).max), dtype=torch.float32)
JAX_GRAD_REL = 2e-2  # tests/test_torch_flash_train.py's bf16 bound for the gradients
DV_REL = 1e-4  # JAX's bound on its kernel's dv against its twin (tests/test_ops.py:654)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, 64) -> (B, H, L, 64) in f32."""
    return x.float().permute(0, 2, 1, 3)


def _di(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_d o g (B, H, T) as the dq kernel sums it: lane t of a quad over
    dims 16 t .. 16 t + 15 in order, then (0 + 1) + (2 + 3)."""
    prod = o * g  # a product of two bf16 values is exact in f32
    parts = []
    for t in range(4):
        acc = torch.zeros(prod.shape[:-1])
        for d in range(16 * t, 16 * t + 16):
            acc = acc + prod[..., d]
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _p_ds(s, dp, ok, m, rl, di):
    """The kernels' p and bf16(ds) of one tile from its raw scores."""
    sv = s * 0.125 + torch.where(ok, torch.zeros(()), MASK)
    p = torch.exp2((sv - m) * LOG2E) * rl
    return p, ((dp - di) * p * 0.125).to(torch.bfloat16).float()


def bwd_tiles(q, k, v, valid, out, stats, g, causal):
    """(dq, dk, dv) in bf16 in the backward kernels' order of work."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    qf, kf, vf, gf, of = (_heads(x) for x in (q, k, v, g, out))
    m, l = (x.reshape(B, H, T) for x in stats)
    rl = 1.0 / l
    di = _di(of, gf)
    okk = valid.to(torch.bool)[:, None, None, :]  # (B, 1, 1, S)
    rows, keys = torch.arange(T), torch.arange(S)
    dq = torch.zeros_like(qf)
    for qb in range(T // BLK):  # the dq kernel: a block per 128 rows
        r = slice(qb * BLK, (qb + 1) * BLK)
        n_kt = min(2 * (qb + 1), S // TILE) if causal else S // TILE
        for it in range(n_kt):
            c = slice(it * TILE, (it + 1) * TILE)
            ok = okk[..., c]
            if causal and it // 2 == qb:
                ok = ok & (keys[c][None, :] <= rows[r][:, None])
            s = qf[:, :, r] @ kf[:, :, c].transpose(-1, -2)
            dp = gf[:, :, r] @ vf[:, :, c].transpose(-1, -2)
            _, ds = _p_ds(s, dp, ok, m[:, :, r, None], rl[:, :, r, None], di[:, :, r, None])
            dq[:, :, r] = dq[:, :, r] + ds @ kf[:, :, c]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kb in range(S // BLK):  # the dk/dv kernel: a block per 128 keys
        c = slice(kb * BLK, (kb + 1) * BLK)
        for it in range(2 * kb if causal else 0, T // TILE):
            r = slice(it * TILE, (it + 1) * TILE)
            ok = okk[..., c].expand(B, 1, TILE, BLK)
            if causal and it // 2 == kb:
                ok = ok & (keys[c][None, :] <= rows[r][:, None])
            s = qf[:, :, r] @ kf[:, :, c].transpose(-1, -2)
            dp = gf[:, :, r] @ vf[:, :, c].transpose(-1, -2)
            p, ds = _p_ds(s, dp, ok, m[:, :, r, None], rl[:, :, r, None], di[:, :, r, None])
            dv_tile = p.to(torch.bfloat16).float().transpose(-1, -2) @ gf[:, :, r]
            dv[:, :, c] = dv[:, :, c] + dv_tile
            dk[:, :, c] = dk[:, :, c] + ds.transpose(-1, -2) @ qf[:, :, r]
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16) for x in (dq, dk, dv))


def _jax_flash_grads(q, k, v, valid, g, causal):
    """JAX's library kernel as ``attend_flash_vjp`` calls it, in interpret
    mode, bf16: (dq, dk, dv) as f32 arrays in the (B, L, H, D) layout."""
    B, T = q.shape[:2]
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))

    def f(q, k, v):
        t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal, sm_scale=0.125))

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v)))
        grads = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in grads)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _inputs(T, S, seed, B=2, H=2):
    """Seeded bf16 q, k, v, g and a key mask: ~10% of keys invalid, the first
    three of batch row 0 among them (its first causal rows have no key to
    attend), batch row 1 with no valid key at all."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                  for shape in ((B, T, H, 64), (B, S, H, 64), (B, S, H, 64), (B, T, H, 64)))
    valid = rng.random((B, S)) >= 0.1
    valid[0, :3] = False
    valid[1] = False
    return q, k, v, g, torch.from_numpy(valid)


CASES = [(t, s, False) for t in (128, 256, 384) for s in (128, 256, 384)] + \
        [(t, t, True) for t in (128, 256, 384)]


@pytest.mark.parametrize("T,S,causal", CASES,
                         ids=[f"T{t}-S{s}-{'causal' if c else 'full'}" for t, s, c in CASES])
def test_bwd_tiles_match_twin_and_jax_vjp(T, S, causal):
    q, k, v, g, valid = _inputs(T, S, seed=T + 3 * S + causal)
    out, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    got = bwd_tiles(q, k, v, valid, out, stats, g, causal)
    twin = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, twin):
        assert torch.isfinite(a.float()).all()
        assert _rel(a, b) < TA_REL[name], (name, _rel(a, b))
    assert _rel(got[2], twin[2]) < DV_REL, _rel(got[2], twin[2])
    want = _jax_flash_grads(q, k, v, valid.numpy(), g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) < JAX_GRAD_REL, (name, _rel(a, b))


def test_causal_whole_tile_skip_leaves_nothing_out():
    """The tiles the kernels skip when causal (keys of blocks past the
    rows') hold p = 0 exactly in the twin, and a diagonal tile whose keys
    all lie past its rows is walked, not skipped: its masked keys take the
    uniform rows' gradient (batch row 1, no valid key)."""
    T = S = 256
    q, k, v, g, valid = _inputs(T, S, seed=5)
    out, stats = ft.flash_train_fwd_reference(q, k, v, valid, True)
    s = ft._masked_scores(q, k, valid, True)
    m, l = (x.reshape(2, 2, T, 1) for x in stats)
    p = ft._exp(s - m) * (1.0 / l)
    assert (p[..., :BLK, BLK:] == 0).all()  # block 0's rows never visit block 1's keys
    got = bwd_tiles(q, k, v, valid, out, stats, g, True)
    twin = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, g, True)
    # keys 64..127 lie past every row 0..63 of their block, and row 1 has
    # no valid key: its rows 0..127 weigh keys 0..127 alike, so those keys'
    # dv is nonzero, from the tile the kernels walk
    assert (got[2][1, 64:128].float().abs().sum(-1) > 0).all()
    assert _rel(got[2], twin[2]) < DV_REL


def test_cuda_wrappers_refuse_misaligned_views():
    """The backward's TMA loads and bulk copies need every tensor's first
    element 16-byte aligned; a view that starts 2 bytes in is refused
    before any launch."""
    buf = torch.zeros(128 * 64 + 8, dtype=torch.bfloat16)
    ok = buf[:128 * 64].view(1, 128, 1, 64)
    off = buf[1:128 * 64 + 1].view(1, 128, 1, 64)
    ft._check_aligned(q=ok, stats=torch.zeros(2, 1, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ft._check_aligned(q=ok, g=off)
    stats = torch.zeros(2 * 128 + 1)[1:].view(2, 1, 128)
    with pytest.raises(ValueError, match="stats must start 16-byte aligned"):
        ft._check_aligned(stats=stats)


# ----------------------------------------------------------------------
# the model's gate: CUDA kernels take bf16 and head_dim 64 only
# ----------------------------------------------------------------------
V = 40
KW = dict(vocab_size=V, num_encoder_layers=1, num_decoder_layers=1, d_ff=64, max_len=256,
          dropout=0.1, pos_dropout=0.0)


def _model(d_model, nhead, dtype, **opts):
    torch.manual_seed(0)
    return ScoreTransformer(ModelConfig(**KW, d_model=d_model, nhead=nhead, dtype=dtype, **opts))


def _batch(L=128):
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(3, V, (2, L)))
    tgt = torch.from_numpy(rng.integers(3, V, (2, L)))
    return src, tgt


def _reset():
    ft.reset_counts(), ta.reset_counts(), attn.reset_counts()


def _twin_calls():
    return (ft.flash_train_fwd_reference.calls + ta.dropout_attention_fwd_reference.calls
            + attn.attention_reference.calls)


GATED = [  # (option, d_model, nhead, dtype, train mode, what the message names)
    ("flash_training", 128, 4, torch.bfloat16, True, "head_dim 32"),
    ("flash_training", 128, 2, torch.float32, False, "torch.float32"),
    ("flash_encoder", 128, 4, torch.bfloat16, False, "head_dim 32"),
    ("flash_encoder", 128, 2, torch.float32, False, "torch.float32"),
    ("fused_attn_train", 256, 2, torch.bfloat16, True, "head_dim 128"),
]


@pytest.mark.parametrize("option,d_model,nhead,dtype,train,named", GATED,
                         ids=[f"{o}-hd{d // h}-{str(t).split('.')[-1]}" for o, d, h, t, _, _ in GATED])
def test_gate_refuses_on_cuda_before_any_attention_call(monkeypatch, option, d_model, nhead, dtype,
                                                        train, named):
    """With the device check standing in for CUDA (the tensors stay on the
    CPU), a model whose option would send its attention through the CUDA
    kernels at a head_dim or dtype they do not take raises
    NotImplementedError naming the option, what it got and ROADMAP Queue 3
    item 4, before any attention runs; on the CPU itself the same model
    runs its twins as before."""
    model = _model(d_model, nhead, dtype, **{option: True})
    src, tgt = _batch()
    gen = torch.Generator().manual_seed(0) if train else None
    run = (lambda: model(src, tgt, deterministic=not train, generator=gen)) if option != "flash_encoder" \
        else (lambda: model.encode(src))
    _reset()
    out = run()
    assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()
    assert _twin_calls() > 0  # the CPU is not gated: the option's twins ran
    monkeypatch.setattr(tr, "_kernel_device", lambda t: True)
    _reset()
    with pytest.raises(NotImplementedError) as err:
        run()
    msg = str(err.value)
    assert option in msg and named in msg and "ROADMAP Queue 3 item 4" in msg, msg
    assert _twin_calls() == 0


@pytest.mark.parametrize("option", ["flash_training", "flash_encoder", "fused_attn_train"])
def test_gate_passes_what_the_kernels_take(monkeypatch, option):
    """bf16 at head_dim 64 passes the gate on CUDA; so does f32 with
    fused_attn_train, which JAX's own gate (``_fused_train_ok``) already
    sends to the plain path, as it does on the CPU."""
    monkeypatch.setattr(tr, "_kernel_device", lambda t: True)
    src, tgt = _batch()
    for dtype in (torch.bfloat16, torch.float32) if option == "fused_attn_train" else (torch.bfloat16,):
        model = _model(128, 2, dtype, **{option: True})
        _reset()
        if option == "flash_encoder":
            out = model.encode(src)
        else:
            out = model(src, tgt, deterministic=False, generator=torch.Generator().manual_seed(0))[0]
        assert torch.isfinite(out).all()
        # f32 with fused_attn_train takes the plain path: no kernel, no twin
        assert (_twin_calls() > 0) == (dtype == torch.bfloat16)


def test_gate_message_cites_an_item_that_names_every_option():
    """ROADMAP Queue 3 item 4 exists and speaks of the three options the
    gate names."""
    text = open("ROADMAP.md").read()
    queue3 = text[text.index("### Queue 3"):]
    item4 = queue3[queue3.index("\n4. "):]
    item4 = item4[:item4.index("\n5. ")] if "\n5. " in item4 else item4
    for word in ("flash_training", "flash_encoder", "fused_attn_train", "head_dim"):
        assert word in item4, word


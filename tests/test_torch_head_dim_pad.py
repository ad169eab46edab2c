"""The attention kernels at head_dims other than 64 and 128, on the CPU.

On CUDA a head_dim h <= 128 that no kernel is built for runs on the next
built width (``ops.attention.kernel_width``; ``flash_train`` in bf16 pads
every h but 64 to 128, ``flash_kernel_width``), with q, k and v
zero-padded on the last axis, the scale kept at 1/sqrt(h) and the outputs
and gradients sliced back.  These tests hold that arithmetic: each twin on
the padded tensors at the scale 1/sqrt(h), sliced, against the same twin at
the true head_dim, forward and backward, for h in 32, 48 and 96.  Zero
columns add exact zeros to every score and product, so the two agree to
f32 rounding: within 1e-6 relative (the sums may be split differently
over the wider axis), and in bf16 within one ulp of the output (2^-7
relative) where an f32 difference crosses a rounding boundary.  The padded
columns of every output and gradient are exactly zero.

Also: ``fused=None`` resolves to the decode kernels only where they fit
(head_dim 64 or 128 and d_model a multiple of 64, a bf16 or an f32 model
alike), as JAX's ``resolve_backend`` does, and an explicit ``fused=True``
that does not fit raises (the device check stands in for CUDA).
"""

import math

import numpy as np
import pytest
import torch

from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import attention_wide as aw
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta
from smer_music_generation_tpu_torch.vocab import CONTROL_SETS, WordVocab

HEAD_DIMS = (32, 48, 96)
F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7


def _qkv(hd, dtype, B=2, T=128, S=128, H=2, seed=0):
    g = np.random.default_rng(seed + hd)
    mk = lambda n: torch.from_numpy(g.standard_normal((B, n, H, hd)).astype(np.float32)).to(dtype)
    valid = torch.from_numpy(g.random((B, S)) < 0.85)
    valid[:, 0] = True
    return mk(T), mk(S), mk(S), valid


def _close(got, want, dtype):
    rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=rtol)


def _padded(hd, width, *ts):
    return [attn.pad_head(t, width) for t in ts]


def test_kernel_widths():
    """Which built head_dim each head_dim runs on; above 128 the next
    multiple of 64, on the wide kernels (``ops/attention_wide.py``)."""
    assert [attn.kernel_width(h) for h in (1, 32, 48, 64, 65, 96, 128)] == [64, 64, 64, 64, 128, 128, 128]
    for h, bf16, f32 in ((32, 128, 64), (48, 128, 64), (64, 64, 64), (96, 128, 128), (128, 128, 128)):
        assert ft.flash_kernel_width(h, torch.bfloat16) == bf16
        assert ft.flash_kernel_width(h, torch.float32) == f32
        assert not aw.is_wide(attn.kernel_width(h))
    for h, width in ((129, 192), (192, 192), (256, 256)):
        assert attn.kernel_width(h) == width and aw.is_wide(width)
        assert ft.flash_kernel_width(h, torch.bfloat16) == ft.flash_kernel_width(h, torch.float32) == width
    x = torch.ones(1, 2, 1, 48)
    assert attn.pad_head(x, 48) is x
    y = attn.pad_head(x, 64)
    assert y.shape[-1] == 64 and y.is_contiguous() and (y[..., 48:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_padded(hd, dtype, causal):
    """``fused_attention``'s padding: the twin on zero-padded q, k, v at
    1/sqrt(h), sliced, against the twin at h."""
    q, k, v, valid = _qkv(hd, dtype)
    lens = valid.sum(1).to(torch.int32)
    width = attn.kernel_width(hd)
    want = attn.attention_reference(q, k, v, lens, causal)
    got = attn.attention_reference(*_padded(hd, width, q, k, v), lens, causal, scale=1 / math.sqrt(hd))
    assert (got[..., hd:] == 0).all()
    _close(got[..., :hd], want, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_train_attention_padded(hd, rate):
    """``fused_dropout_attention``'s padding, forward and backward (bf16,
    the keep mask of the (b, h, t, s) hash alike at both widths)."""
    q, k, v, valid = _qkv(hd, torch.bfloat16, T=96, S=160)
    g = _qkv(hd, torch.bfloat16, T=96, S=160, seed=7)[0]
    seed, width, sc = (3, 9), attn.kernel_width(hd), 1 / math.sqrt(hd)
    pq, pk, pv, pg = _padded(hd, width, q, k, v, g)
    want = ta.dropout_attention_fwd_reference(q, k, v, valid, seed, rate, causal=False)
    got = ta.dropout_attention_fwd_reference(pq, pk, pv, valid, seed, rate, causal=False, scale=sc)
    assert (got[..., hd:] == 0).all()
    _close(got[..., :hd], want, torch.bfloat16)
    want_g = ta.dropout_attention_bwd_reference(q, k, v, valid, seed, g, rate)
    got_g = ta.dropout_attention_bwd_reference(pq, pk, pv, valid, seed, pg, rate, scale=sc)
    for a, b in zip(got_g, want_g):
        assert (a[..., hd:] == 0).all()
        _close(a[..., :hd], b, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_train_padded(hd, dtype):
    """``flash_train_attention``'s padding (to 128 in bf16, the next built
    width in f32), forward and backward, causal over 2 blocks."""
    q, k, v, valid = _qkv(hd, dtype, T=256, S=256)
    g = _qkv(hd, dtype, T=256, S=256, seed=5)[0]
    width, sc = ft.flash_kernel_width(hd, dtype), 1 / math.sqrt(hd)
    pq, pk, pv, pg = _padded(hd, width, q, k, v, g)
    want, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal=True)
    got, pstats = ft.flash_train_fwd_reference(pq, pk, pv, valid, causal=True, scale=sc)
    assert (got[..., hd:] == 0).all()
    _close(got[..., :hd], want, dtype)
    _close(pstats, stats, torch.float32)
    want_g = ft.flash_train_bwd_reference(q, k, v, valid, want, stats, g, causal=True)
    got_g = ft.flash_train_bwd_reference(pq, pk, pv, valid, attn.pad_head(want, width), stats, pg,
                                         causal=True, scale=sc)
    for a, b in zip(got_g, want_g):
        assert (a[..., hd:] == 0).all()
        _close(a[..., :hd], b, dtype)


def _decoder_model(d_model, nhead, dtype):
    vocab = WordVocab(0, CONTROL_SETS[5])
    torch.manual_seed(0)
    cfg = ModelConfig(vocab_size=vocab.vocab_size, d_model=d_model, nhead=nhead, num_encoder_layers=1,
                      num_decoder_layers=1, d_ff=64, max_len=64, dtype=dtype)
    return ScoreTransformer(cfg).eval(), vocab


@pytest.mark.parametrize("d_model,nhead,dtype,kernels", [
    (64, 2, torch.bfloat16, False),  # head_dim 32
    (384, 4, torch.bfloat16, False),  # head_dim 96
    (128, 2, torch.float32, True),  # head_dim 64 in f32: JAX's gate has no dtype condition
    (128, 2, torch.bfloat16, True),
    (256, 2, torch.bfloat16, True),
    (256, 2, torch.float32, True),  # head_dim 128 in f32
], ids=["hd32", "hd96", "hd64-f32", "hd64-bf16", "hd128-bf16", "hd128-f32"])
def test_decoder_resolves_auto_as_jax(monkeypatch, d_model, nhead, dtype, kernels):
    """With the device check standing in for CUDA, ``fused=None`` takes the
    decode kernels only where they fit (head_dim 64 or 128, d_model % 64,
    bf16 or f32: JAX's ``_kernel_fits`` :133-136 has no dtype condition)
    and the plain loop elsewhere, as JAX's (:169-172); an explicit
    ``fused=True`` that does not fit raises (JAX :138-141).  On the CPU
    itself ``fused=None`` is the plain loop."""
    model, vocab = _decoder_model(d_model, nhead, dtype)
    assert InfillDecoder(model, vocab, max_tgt_len=32).fused is False
    monkeypatch.setattr(decode_mod, "_kernel_device", lambda dev: True)
    assert InfillDecoder(model, vocab, max_tgt_len=32).fused is kernels
    if kernels:
        assert InfillDecoder(model, vocab, max_tgt_len=32, fused=True).fused is True
    else:
        with pytest.raises(ValueError, match="fused=False"):
            InfillDecoder(model, vocab, max_tgt_len=32, fused=True)
    assert InfillDecoder(model, vocab, max_tgt_len=32, fused=False).fused is False

"""The flash-attention forward and the flash encoder: the port's twin of
``fused_attention`` and ``encode`` with ``flash_encoder=True`` against the
JAX package, on the CPU.

The JAX side runs ``fused_attention(..., interpret=True)`` (and, inside its
flash encoder, the same kernel in interpret mode, its default off a TPU),
as ``tests/test_ops.py`` runs it.  Inputs are made with numpy from a seed;
the encoder is the small f32 model pair (d_model 128, 2 heads of 64, 2
layers, random biases and LayerNorms).

Tolerances: the twin against the Pallas kernel within atol 2e-5 + rtol
1e-4, the bound ``tests/test_ops.py`` holds the kernel to against JAX's
reference (f32 sums in another order: the kernel walks the keys in blocks
with an online softmax); the encoders within atol 1e-4 (the same
difference carried through two layers and their LayerNorms), on the valid
rows of each sequence (a padding row's output is never read).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu.ops.attention import attention_reference as jref
from smer_music_generation_tpu.ops.attention import fused_attention as jfused
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.ops import attention as attn
from tests.torch_port_helpers import model_pair

ATOL, RTOL = 2e-5, 1e-4
ENC_ATOL = 1e-4


def _qkv(B, T, S, H=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, D), (B, S, H, D), (B, S, H, D)))


CASES = [  # (B, T, S, key lengths or None, causal)
    (2, 64, 64, None, False),
    (3, 40, 70, [70, 33, 1], False),
    (1, 48, 48, None, True),
    (2, 37, 53, None, False),
    (3, 100, 77, [77, 50, 3], True),
    (2, 96, 128, [0, 128], False),
]


@pytest.mark.parametrize("B,T,S,lens,causal", CASES,
                         ids=[f"B{b}-T{t}-S{s}-{'lens' if n else 'full'}-{'causal' if c else 'bidir'}"
                              for b, t, s, n, c in CASES])
def test_twin_matches_pallas_kernel(B, T, S, lens, causal):
    q, k, v = _qkv(B, T, S, seed=T + S)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    want = jfused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid_len=jl, causal=causal,
                  blk_q=32, blk_kv=32, interpret=True)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    before = attn.attention_reference.calls
    got = attn.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               kv_valid_len=tl, causal=causal)  # CPU tensors: the twin
    assert attn.attention_reference.calls == before + 1
    assert got.shape == (B, T, 2, 64) and got.dtype == torch.float32
    rows = np.ones(B, bool) if lens is None else np.asarray(lens) > 0
    # a sequence with no valid key: the twin weighs all S keys alike (JAX's
    # reference), the Pallas kernel all S padded to its block; not compared
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_valid_len=jl, causal=causal)), atol=ATOL, rtol=RTOL)


def test_twin_keeps_the_input_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 8, 8))
    out = attn.attention_reference(q, k, v, torch.tensor([5], dtype=torch.int32), causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 2, 64)


def test_wrapper_refuses_other_devices():
    meta = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        attn.fused_attention(meta, meta, meta)


@pytest.fixture(scope="module")
def flash_pair():
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=61, flash_encoder=True)
    return vocab, jmodel, params, tmodel


@pytest.mark.parametrize("S,pad_from", [(64, [64, 40, 9]), (130, [130, 77, 128])],
                         ids=["S64", "S130"])
def test_flash_encode_matches_jax_and_the_plain_encode(flash_pair, S, pad_from):
    """``encode`` with ``flash_encoder=True``: the JAX flash encode's output
    and the port's plain encode's, on every valid row, with one launch of
    the flash path per encoder layer."""
    vocab, jmodel, params, tmodel = flash_pair
    B = len(pad_from)
    rng = np.random.default_rng(S)
    src = rng.integers(1, vocab.vocab_size, size=(B, S)).astype(np.int32)
    pad = np.arange(S)[None, :] >= np.asarray(pad_from)[:, None]
    src[pad] = 0
    want = np.asarray(jmodel.apply(params, jnp.asarray(src), jnp.asarray(pad),
                                   method=JScoreTransformer.encode))
    assert tmodel.cfg.flash_encoder
    before = attn.attention_reference.calls
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(src).long(), torch.from_numpy(pad)).numpy()
    assert attn.attention_reference.calls == before + tmodel.cfg.num_encoder_layers
    valid = ~pad
    np.testing.assert_allclose(got[valid], want[valid], atol=ENC_ATOL, rtol=0)

    import dataclasses

    from smer_music_generation_tpu_torch.models.transformer import ScoreTransformer

    plain = ScoreTransformer(dataclasses.replace(tmodel.cfg, flash_encoder=False))
    plain.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        base = plain.eval().encode(torch.from_numpy(src).long(), torch.from_numpy(pad)).numpy()
    assert attn.attention_reference.calls == before + tmodel.cfg.num_encoder_layers
    np.testing.assert_allclose(got[valid], base[valid], atol=ENC_ATOL, rtol=0)


def test_flash_encode_without_a_pad_mask(flash_pair):
    """No mask: every key is valid (JAX :576-578)."""
    vocab, jmodel, params, tmodel = flash_pair
    src = np.random.default_rng(3).integers(1, vocab.vocab_size, size=(2, 48)).astype(np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(src), method=JScoreTransformer.encode))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(src).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)

"""The port's ScoreTransformer against the Flax model, in f32 on the CPU.

Tolerance: atol 1e-4 on activations and logits.  Both sides compute in
f32 with the same formulas; what differs is the summation order of the
matmuls and reductions (and XLA's transcendental approximations), which
moves results by a few f32 ulps per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from tests.torch_port_helpers import model_pair

ATOL = 1e-4


def _src(B, S, V, seed, pad_from=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, V, size=(B, S)).astype(np.int32)
    pad = np.zeros((B, S), bool)
    if pad_from is not None:
        pad[0, pad_from:] = True
        src[0, pad_from:] = 0
    return src, pad


def _jit(jmodel, method):
    return jax.jit(lambda params, *a: jmodel.apply(params, *a, method=getattr(JScoreTransformer, method)))


def _decode_steps(jmodel, params, tmodel, src, pad, tokens, L):
    """Run len(tokens) cached decode steps on both; yield logits pairs."""
    B = src.shape[0]
    jmem = _jit(jmodel, "encode")(params, jnp.asarray(src), jnp.asarray(pad))
    jcross = _jit(jmodel, "init_cross_cache")(params, jmem)
    jcache = jmodel.apply(params, B, L, method=JScoreTransformer.init_self_cache)
    jstep = _jit(jmodel, "decode_step")
    tsrc, tpad = torch.from_numpy(src).long(), torch.from_numpy(pad)
    with torch.no_grad():
        tmem = tmodel.encode(tsrc, tpad)
        tcross = tmodel.init_cross_cache(tmem)
        tcache = tmodel.init_self_cache(B, L)
        for pos, tok in enumerate(tokens):
            jl, jcache = jstep(params, jnp.asarray(tok), pos, jcache, jcross, jnp.asarray(pad))
            tl = tmodel.decode_step(torch.from_numpy(tok).long(), pos, tcache, tcross, tpad)
            yield np.asarray(jl), tl.numpy()


def test_encode_and_cross_cache_match_flax():
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size)
    src, pad = _src(2, 40, vocab.vocab_size, seed=1, pad_from=23)
    jmem = _jit(jmodel, "encode")(params, jnp.asarray(src), jnp.asarray(pad))
    with torch.no_grad():
        tmem = tmodel.encode(torch.from_numpy(src).long(), torch.from_numpy(pad))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), atol=ATOL, rtol=0)
    jcross = _jit(jmodel, "init_cross_cache")(params, jmem)
    with torch.no_grad():
        tcross = tmodel.init_cross_cache(tmem)
    for key, (jk, jv) in jcross.items():
        tk, tv = tcross[key]
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B", [1, 3])
def test_decode_step_logits_match_flax(B):
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=2)
    src, pad = _src(B, 48, vocab.vocab_size, seed=3, pad_from=30)
    tokens = np.random.default_rng(4).integers(1, vocab.vocab_size, size=(6, B)).astype(np.int32)
    for jl, tl in _decode_steps(jmodel, params, tmodel, src, pad, tokens, L=64):
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
        assert (tl.argmax(-1) == jl.argmax(-1)).all()


def test_trained_snapshot_matches_flax_f32():
    """Flagship width on the committed snapshot: both packages load it
    (the port with its own msgpack reader), a few decode positions agree."""
    from smer_music_generation_tpu.train.state import load_inference_model as jload
    from smer_music_generation_tpu.utils.config import ExperimentConfig
    from smer_music_generation_tpu_torch.train.state import (
        default_flagship_snapshot,
        load_inference_model,
    )
    from smer_music_generation_tpu_torch.utils.config import ExperimentConfig as TConfig

    path = default_flagship_snapshot()
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, _ = jload(ExperimentConfig(), vocab.vocab_size, path, jnp.float32)
    tmodel, epoch = load_inference_model(
        TConfig(), vocab.vocab_size, path, torch.float32, device="cpu"
    )
    assert epoch == 17
    src, pad = _src(1, 64, vocab.vocab_size, seed=5)
    tokens = np.random.default_rng(6).integers(1, vocab.vocab_size, size=(3, 1)).astype(np.int32)
    for jl, tl in _decode_steps(jmodel, params, tmodel, src, pad, tokens, L=16):
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
        assert (tl.argmax(-1) == jl.argmax(-1)).all()

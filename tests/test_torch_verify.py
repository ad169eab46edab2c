"""The W-row verify window of speculative decode: the port's twin of
``fused_verify_window`` and its ``ScoreTransformer.decode_window`` against
the JAX package.

The JAX side runs ``fused_verify_window(..., interpret=True)``, as
``tests/test_ops.py`` runs it, and its ``decode_window``.  Shapes: d_model
128, 2 heads (head_dim 64), 2 decoder layers, d_ff 256, f32, L = S = 512,
random biases and LayerNorms; window rows, cache rows and cross rows made
with numpy from a seed.

Tolerances: logits and ``new_kv`` within atol 1e-4 against the Pallas
kernel (the twin takes one softmax over the cache and the window rows, the
kernel walks the cache in 128-row blocks and the window apart: the same f32
products summed in another order, as the v2 step's tests allow), and within
atol 1e-4 between the two ``decode_window``s and against W sequential
``decode_step`` calls; the argmax of every row is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu.ops import decode_step as jds
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.ops import decode_step as ds
from tests.torch_port_helpers import model_pair

ATOL = 1e-4
L = S = 512
CROSS_LEN = 400


@pytest.fixture(scope="module")
def setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=81)
    vpad = ds.vocab_pad(vocab.vocab_size)
    return vocab, jmodel, params, tmodel, vpad


def _statics(cfg, vpad):
    return dict(n_layers=cfg.num_decoder_layers, d_model=cfg.d_model, nhead=cfg.nhead,
                d_ff=cfg.d_ff, vpad=vpad)


def _inputs(W, D, nl, index, seed):
    """Window rows (W, D), a cache whose first ``index`` rows are random and
    the rest zero (1 sequence), cross rows and a cross length."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((W, D)).astype(np.float32)
    self_kv = np.zeros((nl, 1, L, 2 * D), np.float32)
    self_kv[:, :, :index] = rng.standard_normal((nl, 1, index, 2 * D))
    cross_kv = rng.standard_normal((nl, 1, S, 2 * D)).astype(np.float32)
    return x, self_kv, cross_kv, np.asarray([CROSS_LEN], np.int32)


@pytest.mark.parametrize("W", [6, 9])
@pytest.mark.parametrize("index", [0, 300], ids=["cold", "warm"])
def test_twin_matches_pallas_verify(setup, W, index):
    _, jmodel, params, tmodel, vpad = setup
    cfg = jmodel.cfg
    kw = _statics(cfg, vpad)
    x, self_kv, cross_kv, cross_len = _inputs(W, cfg.d_model, cfg.num_decoder_layers, index,
                                              seed=10 * W + index)
    packed = jds.pack_decoder_weights(params, cfg, vpad)
    jl, jkv = jds.fused_verify_window(
        packed, jnp.asarray(x), jnp.asarray(self_kv), jnp.asarray(cross_kv), jnp.int32(index),
        jnp.asarray(cross_len), interpret=True, **kw)
    before = ds.fused_verify_window_reference.calls
    tl, tkv = ds.fused_verify_window(  # CPU tensors: the wrapper runs the twin
        ds.pack_decoder_weights(tmodel, vpad), torch.from_numpy(x), torch.from_numpy(self_kv),
        torch.from_numpy(cross_kv), index, torch.from_numpy(cross_len), **kw)
    assert ds.fused_verify_window_reference.calls == before + 1
    assert tuple(tl.shape) == (W, vpad) and tuple(tkv.shape) == (cfg.num_decoder_layers, W, 2 * cfg.d_model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)
    V = cfg.vocab_size
    np.testing.assert_array_equal(tl[:, :V].numpy().argmax(-1), np.asarray(jl)[:, :V].argmax(-1))


@pytest.mark.parametrize("W", [16, 24])
def test_twin_equals_sequential_v2_steps(setup, W):
    """Row j of the twin is the v2 twin's step at index + j over the cache
    spliced with rows 0..j-1: the window's definition, at W = 16 (one
    row-vector launch on the card) and W = 24 (two, 16 + 8)."""
    _, jmodel, _, tmodel, vpad = setup
    cfg = jmodel.cfg
    kw = _statics(cfg, vpad)
    index = 100
    x, self_kv, cross_kv, cross_len = (torch.from_numpy(a) for a in _inputs(
        W, cfg.d_model, cfg.num_decoder_layers, index, seed=5))
    packed = ds.pack_decoder_weights(tmodel, vpad)
    logits, new_kv = ds.fused_verify_window_reference(packed, x, self_kv, cross_kv, index,
                                                      cross_len, **kw)
    cache = self_kv.clone()
    for j in range(W):
        lg, kv = ds.fused_decode_step_reference(packed, x[j : j + 1], cache, cross_kv, index + j,
                                                cross_len, **kw)
        cache[:, :, index + j] = kv
        assert torch.equal(lg[0], logits[j])
        assert torch.equal(kv[:, 0], new_kv[:, j])


def test_verify_refuses_int8_and_other_devices(setup):
    """JAX refuses int8 weights in the verify (:1397); so do the twin and
    the CUDA wrapper, and a device that is neither the CPU nor CUDA."""
    _, jmodel, _, tmodel, vpad = setup
    cfg = jmodel.cfg
    kw = _statics(cfg, vpad)
    x, self_kv, cross_kv, cross_len = (torch.from_numpy(a) for a in _inputs(
        2, cfg.d_model, cfg.num_decoder_layers, 4, seed=6))
    packed = ds.pack_decoder_weights(tmodel, vpad, quant="int8")
    with pytest.raises(ValueError, match="int8"):
        ds.fused_verify_window(packed, x, self_kv, cross_kv, 4, cross_len, **kw)
    meta = torch.empty(2, cfg.d_model, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.fused_verify_window({}, meta, meta, meta, 0, meta, **kw)


@pytest.mark.parametrize("index", [0, 37], ids=["cold", "warm"])
def test_decode_window_matches_jax(setup, index):
    """The port's ``decode_window`` against JAX's on the same caches: logits
    (B, W, V) and the K/V it writes at index.. index + W - 1."""
    vocab, jmodel, params, tmodel, _ = setup
    cfg = jmodel.cfg
    W, B = 5, 2
    rng = np.random.default_rng(7 + index)
    src = rng.integers(1, vocab.vocab_size, size=(B, 64)).astype(np.int32)
    pad = np.zeros((B, 64), bool)
    pad[1, 40:] = True
    src[pad] = 0
    prefix = rng.integers(1, vocab.vocab_size, size=(B, index)).astype(np.int32)
    tokens = rng.integers(1, vocab.vocab_size, size=(B, W)).astype(np.int32)

    mem = jmodel.apply(params, jnp.asarray(src), jnp.asarray(pad), method=JScoreTransformer.encode)
    jcross = jmodel.apply(params, mem, method=JScoreTransformer.init_cross_cache)
    jcache = jmodel.apply(params, B, 128, method=JScoreTransformer.init_self_cache)
    if index:
        _, jcache = jmodel.apply(params, jnp.asarray(prefix), jnp.int32(0), jcache, jcross,
                                 jnp.asarray(pad), method=JScoreTransformer.decode_window)
    jl, jcache = jmodel.apply(params, jnp.asarray(tokens), jnp.int32(index), jcache, jcross,
                              jnp.asarray(pad), method=JScoreTransformer.decode_window)

    tpad = torch.from_numpy(pad)
    with torch.no_grad():
        tcross = tmodel.init_cross_cache(tmodel.encode(torch.from_numpy(src).long(), tpad))
        tcache = tmodel.init_self_cache(B, 128)
        if index:
            tmodel.decode_window(torch.from_numpy(prefix).long(), 0, tcache, tcross, tpad)
        tl = tmodel.decode_window(torch.from_numpy(tokens).long(), index, tcache, tcross, tpad)
    assert tuple(tl.shape) == (B, W, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for i in range(cfg.num_decoder_layers):
        for a, b in zip(tcache[f"layer_{i}"], jcache[f"layer_{i}"]):
            np.testing.assert_allclose(a[:, : index + W].numpy(), np.asarray(b)[:, : index + W],
                                       atol=ATOL, rtol=0)


def test_decode_window_equals_sequential_steps(setup):
    """W rows of ``decode_window`` equal W sequential ``decode_step`` calls
    (JAX ``test_decode_window_matches_stepwise`` on the port)."""
    vocab, _, _, tmodel, _ = setup
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(1, 48)))
    prefix = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(1, 3)))
    tokens = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(1, 7)))
    with torch.no_grad():
        cross = tmodel.init_cross_cache(tmodel.encode(src))
        win_cache, step_cache = tmodel.init_self_cache(1, 64), tmodel.init_self_cache(1, 64)
        for cache in (win_cache, step_cache):
            tmodel.decode_window(prefix, 0, cache, cross)
        window = tmodel.decode_window(tokens, 3, win_cache, cross)
        steps = torch.stack([tmodel.decode_step(tokens[:, j], 3 + j, step_cache, cross)
                             for j in range(7)], dim=1)
    np.testing.assert_allclose(window.numpy(), steps.numpy(), atol=ATOL, rtol=0)


def test_twin_on_model_caches_matches_decode_window(setup):
    """The decoder's fused verify (packed weights, stacked cross K|V, the
    f32 embedding plus PE rows in the compute dtype) gives the logits of the
    model's own ``decode_window`` at a warm position."""
    vocab, jmodel, _, tmodel, vpad = setup
    cfg = jmodel.cfg
    kw = _statics(cfg, vpad)
    nl, D = cfg.num_decoder_layers, cfg.d_model
    rng = np.random.default_rng(12)
    src = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(1, 80)))
    pad = torch.zeros(1, 80, dtype=torch.bool)
    pad[0, 60:] = True
    tokens = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(9,)))
    index = 20
    with torch.no_grad():
        cross = tmodel.init_cross_cache(tmodel.encode(src, pad))
        cache = tmodel.init_self_cache(1, 64)
        prefix = torch.from_numpy(rng.integers(1, vocab.vocab_size, size=(1, index)))
        tmodel.decode_window(prefix, 0, cache, cross, pad)
        kv = torch.zeros(nl, 1, 64, 2 * D)
        for i in range(nl):
            k, v = cache[f"layer_{i}"]
            kv[i, 0, :index] = torch.cat([k[0, :index].reshape(index, D), v[0, :index].reshape(index, D)], -1)
        want = tmodel.decode_window(tokens[None], index, cache, cross, pad)[0]
        x = tmodel.embedding.weight[tokens] * D ** 0.5 + tmodel.pos_table[index : index + 9]
        got, _ = ds.fused_verify_window(ds.pack_decoder_weights(tmodel, vpad), x, kv,
                                        ds.stack_kv_cache(cross, nl), index,
                                        (~pad).sum(1).to(torch.int32), **kw)
    np.testing.assert_allclose(got[:, : cfg.vocab_size].numpy(), want.numpy(), atol=ATOL, rtol=0)


"""The kernel-looped token chunk (v4): the port's twin and decoder loop
against the JAX package.

The JAX side runs ``fused_decode_tokens(..., interpret=True)`` and its v4
decoder loop in interpret mode, as ``tests/test_ops.py`` does.  Shapes:
d_model 128, 2 heads (head_dim 64), 2 decoder layers, d_ff 256, f32
compute, L = S = 512 plus v4's 64 slop rows, random biases and LayerNorms,
SMER and REMI.  Inputs, states and Gumbel noise are made with numpy from a
seed, or drawn by JAX and handed to the port as numpy.

Tolerances: states, tokens, lengths and step counts are compared exactly;
``new_kv`` within atol 1e-4 (the twin takes one softmax over the cache and
the chunk rows, the Pallas kernel walks them as separate blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer import grammar as jg
from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.ops import decode_step as jds
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer.decode import CHUNK_SLOP, InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.test_torch_decode_token import _random_state, _statics
from tests.torch_port_helpers import model_pair, serving_events

ATOL = 1e-4
L = S = 512
Lp = L + CHUNK_SLOP


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=71 + mode)
    vpad = ds.vocab_pad(vocab.vocab_size)
    jt = jg.GrammarTables.build(vocab)
    jtables = jds.pack_sampling_tables(vocab, jt, jg.build_fast_tables(jt), vpad)
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, fused=False)
    events = serving_events(tvocab)
    reqs = [
        eng.prepare(events, [0], [1]),
        eng.prepare(events, [1], [2, 3]),
        eng.prepare(events, [0, 1], [0]),
        eng.prepare(events, [0], [5, 6, 7]),
    ]
    requests = eng._assemble(reqs)[:4]
    return mode, vocab, tvocab, jmodel, params, tmodel, vpad, jtables, requests


CHUNK_CASES = [  # (quant, T_chunk, B, greedy, base index)
    ("none", 4, 1, True, 0),
    ("none", 8, 4, False, 300),
    ("int8", 4, 4, False, 1),
    ("int8", 8, 1, True, 500),
]


@pytest.mark.parametrize(
    "quant,T,B,greedy,index", CHUNK_CASES,
    ids=[f"{q}-T{t}-B{b}-{'greedy' if g else 'nucleus'}" for q, t, b, g, _ in CHUNK_CASES],
)
def test_twin_matches_pallas_kernel(setup, quant, T, B, greedy, index):
    mode, vocab, _, jmodel, params, tmodel, vpad, jtables, _ = setup
    cfg = jmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    kw = _statics(vocab, vpad, cfg, greedy, None if greedy else 0.9, 1.0)
    jpacked = jds.pack_decoder_weights(params, cfg, vpad, quant=quant)
    tpacked = ds.pack_decoder_weights(tmodel, vpad, quant=quant)
    ttables = {k: torch.from_numpy(np.asarray(v)) for k, v in jtables.items()}
    rng = np.random.default_rng(100 * mode + 10 * T + B)
    state, aux, span_types = _random_state(rng, B, vocab.vocab_size)
    state[ds.ST_DONE, 0] = 0  # a live row in every case
    noise = rng.gumbel(size=(Lp, B, vpad)).astype(np.float32)
    self_kv = rng.normal(size=(nl, B, Lp, 2 * D)).astype(np.float32)
    cross_kv = rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)
    cross_len = np.asarray([S - 97 * b for b in range(B)], np.int32)
    js, jtok, jkv = jds.fused_decode_tokens(
        jpacked, jtables, jnp.asarray(state), jnp.asarray(aux), jnp.asarray(span_types),
        jnp.asarray(noise), jnp.asarray(self_kv), jnp.asarray(cross_kv), index,
        jnp.asarray(cross_len), interpret=True, T_chunk=T, **kw,
    )
    before = ds.fused_decode_tokens_reference.calls
    t_self_kv = torch.from_numpy(self_kv)
    ts, ttok, tkv = ds.fused_decode_tokens(  # CPU tensors: the wrapper runs the twin
        tpacked, ttables, torch.from_numpy(state), torch.from_numpy(aux),
        torch.from_numpy(span_types), None if greedy else torch.from_numpy(noise),
        t_self_kv, torch.from_numpy(cross_kv), index, torch.from_numpy(cross_len),
        T_chunk=T, **kw,
    )
    assert ds.fused_decode_tokens_reference.calls == before + 1
    assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (T, B)
    assert tuple(tkv.shape) == (nl, T, B, 2 * D)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t_self_kv.numpy(), self_kv)  # the cache is not written


DECODER_CASES = [  # (B, greedy, span_cap, token_chunk)
    (1, True, 40, 4),
    (4, False, 12, 8),
]


@pytest.mark.parametrize(
    "B,greedy,span_cap,T", DECODER_CASES,
    ids=[f"B{b}-{'greedy' if g else 'nucleus'}-cap{c}-T{t}" for b, g, c, t in DECODER_CASES],
)
def test_v4_decoder_matches_jax_v4_and_port_v3(setup, B, greedy, span_cap, T):
    """The port's ``token_chunk`` loop against JAX's v4 loop (which draws
    its noise over L + 64 rows) and against the port's v3 loop on the first
    L of those rows: tokens, lengths and steps equal."""
    _, vocab, tvocab, jmodel, params, tmodel, vpad, _, requests = setup
    args = tuple(a[:B] for a in requests)
    kw = dict(max_tgt_len=L, span_cap=span_cap, greedy=greedy, nucleus_p=None if greedy else 0.9)
    rng = jax.random.PRNGKey(13)
    jdec = JDecoder(jmodel, vocab, fused=True, fused_sampling=True, interpret=True,
                    token_chunk=T, **kw)
    want = jdec(params, *args, rng)
    noise = None if greedy else np.asarray(
        jax.random.gumbel(rng, (Lp, B, vpad), dtype=np.float32))
    v4 = InfillDecoder(tmodel, tvocab, fused=True, token_chunk=T, **kw)(*args, noise=noise)
    v3 = InfillDecoder(tmodel, tvocab, fused=True, **kw)(
        *args, noise=None if greedy else noise[:L])
    for got in (v4, v3):
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert got.steps == int(want.steps)


def test_v4_and_v3_draw_the_same_noise(setup):
    """With the decoder's own generator a v4 decode gives the v3 decode's
    tokens from the same seed, and leaves the generator where v3 leaves it,
    so a retry draws the same noise under both."""
    _, _, tvocab, _, _, tmodel, _, _, requests = setup
    args = tuple(a[:2] for a in requests)
    kw = dict(max_tgt_len=128, span_cap=12, nucleus_p=0.9, fused=True, seed=4)
    v3, v4 = InfillDecoder(tmodel, tvocab, **kw), InfillDecoder(tmodel, tvocab, token_chunk=8, **kw)
    for _ in range(2):  # the second decode starts from the advanced generator
        a, b = v3(*args), v4(*args)
        np.testing.assert_array_equal(b.tokens.numpy(), a.tokens.numpy())
        np.testing.assert_array_equal(b.lengths.numpy(), a.lengths.numpy())
        assert b.steps == a.steps


def test_kernel_looped_v4_respects_cap(setup):
    """The port's version of JAX's test of the same name: a stream still live
    at max_tgt_len runs on into the slop rows inside its last chunk; v4 must
    clamp its length to L, return (B, L) tokens equal to v3's and v3's step
    count L - 1."""
    _, vocab, tvocab, _, _, tmodel, _, _, requests = setup
    Lc = 128
    src = requests[0][:1]
    n_spans = np.asarray([160])  # 160 spans cannot fit in 128 tokens
    span_types = np.tile([0, 1, 2, 3], 64)[None, :256]
    args = (src, span_types, n_spans, np.asarray([False]))
    kw = dict(max_tgt_len=Lc, nucleus_p=None, greedy=True, fused=True)
    r3 = InfillDecoder(tmodel, tvocab, **kw)(*args)
    r4 = InfillDecoder(tmodel, tvocab, token_chunk=8, **kw)(*args)
    assert int(r3.lengths[0]) == Lc  # the cap is actually hit
    assert tuple(r4.tokens.shape) == (1, Lc)
    assert int(r4.lengths[0]) == Lc
    np.testing.assert_array_equal(r4.tokens.numpy(), r3.tokens.numpy())
    assert r3.steps == Lc - 1
    assert r4.steps == r3.steps


def test_kernel_looped_v4_steps_all_done_at_start(setup):
    """The port's version of JAX's test of the same name: with no span in any
    row the v3 loop never runs (steps 0); v4 must not report max(ST_LEN) = 1."""
    _, _, tvocab, _, _, tmodel, _, _, requests = setup
    src, span_types, _, no_whole = (a[:2] for a in requests)
    kw = dict(max_tgt_len=L, nucleus_p=None, greedy=True, fused=True)
    args = (src, span_types, np.zeros(2, np.int64), no_whole)
    r3 = InfillDecoder(tmodel, tvocab, **kw)(*args)
    r4 = InfillDecoder(tmodel, tvocab, token_chunk=8, **kw)(*args)
    assert r3.steps == 0 and r4.steps == 0
    np.testing.assert_array_equal(r4.lengths.numpy(), r3.lengths.numpy())
    np.testing.assert_array_equal(r4.tokens.numpy(), r3.tokens.numpy())


def test_token_chunk_needs_the_fused_sampling_loop(setup):
    _, _, tvocab, _, _, tmodel, _, _, _ = setup
    with pytest.raises(ValueError, match="fused-sampling"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, token_chunk=4)  # the CPU default is plain
    with pytest.raises(ValueError, match="fused-sampling"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, fused_sampling=False, token_chunk=4)
    with pytest.raises(ValueError, match="token_chunk"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, token_chunk=CHUNK_SLOP + 1)
    dec = InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, token_chunk=CHUNK_SLOP)
    assert dec.fused_sampling is True
    with pytest.raises(ValueError, match="noise has shape"):  # v4 takes L + 64 noise rows
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, token_chunk=4)(
            np.ones((1, 8), np.int64), np.zeros((1, 256), np.int64), np.ones(1, np.int64),
            np.asarray([False]), noise=np.zeros((L, 1, 384), np.float32))

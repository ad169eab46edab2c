"""The port's InfillDecoder is token-exact with the JAX InfillDecoder.

Same weights (a small model, JAX init), same requests (serving streams of
the two-track test score, masked by the port's engine), and for nucleus
sampling the same noise: ``jax.random.gumbel(rng, (L, B, V))`` for the XLA
and v2 loops and ``(L, B, vpad)`` for the v3 loop, which the JAX decoder
draws itself and the port is handed as numpy.  Compared against the XLA
loop (``fused=False``), the v2 kernel loop (``fused=True,
fused_sampling=False, interpret=True``) and the v3 kernel loop
(``fused=True, fused_sampling=True, interpret=True``); the port runs its
plain loop and its kernel loops (the twins, on the CPU).  Tokens, lengths
and step counts must be equal.
"""

import jax
import numpy as np
import pytest

from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.ops.decode_step import vocab_pad
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, serving_events

L = 512


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=21 + mode)
    events = serving_events(tvocab)
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, fused=False)
    reqs = [
        eng.prepare(events, [0], [1]),
        eng.prepare(events, [1], [2, 3]),
        eng.prepare(events, [0, 1], [0]),
        eng.prepare(events, [0], [5, 6, 7]),
    ]
    src, span_types, n_spans, no_whole, _ = eng._assemble(reqs)
    return vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole)


CASES = [  # (B, greedy, jax fused, span_cap); caps below 100 bound the steps
    (1, True, False, 100),
    (1, False, False, 40),
    (4, True, False, 40),
    (4, False, False, 40),
    (4, False, True, 40),
    (4, True, False, 12),
]


@pytest.mark.parametrize(
    "B,greedy,jax_fused,span_cap", CASES,
    ids=[f"B{b}-{'greedy' if g else 'nucleus'}-{'v2' if f else 'xla'}-cap{c}"
         for b, g, f, c in CASES],
)
def test_decoder_token_exact(setup, B, greedy, jax_fused, span_cap):
    vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[:B], span_types[:B], n_spans[:B], no_whole[:B])
    kw = dict(max_tgt_len=L, span_cap=span_cap, greedy=greedy,
              nucleus_p=None if greedy else 0.9)
    rng = jax.random.PRNGKey(5)
    jdec = JDecoder(jmodel, vocab, fused=jax_fused, fused_sampling=False,
                    interpret=jax_fused, **kw)
    want = jdec(params, *args, rng)
    noise = None if greedy else np.asarray(
        jax.random.gumbel(rng, (L, B, vocab.vocab_size), dtype=np.float32)
    )
    for fused in (False, True):
        got = InfillDecoder(tmodel, tvocab, fused=fused, fused_sampling=False, **kw)(
            *args, noise=noise
        )
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert got.steps == int(want.steps)
    if span_cap < 100:
        # the cap counts the introducing m_0: no span holds more than span_cap tokens
        toks = got.tokens.numpy()
        for b in range(B):
            marks = np.flatnonzero(toks[b] == tvocab.mask_index)
            bounds = list(marks) + [int(got.lengths[b])]
            assert max(np.diff(bounds)) <= span_cap


V3_CASES = [  # (B, greedy, span_cap)
    (1, True, 40),
    (1, False, 40),
    (4, True, 12),
    (4, False, 40),
    (4, False, 12),
]


@pytest.mark.parametrize(
    "B,greedy,span_cap", V3_CASES,
    ids=[f"B{b}-{'greedy' if g else 'nucleus'}-cap{c}" for b, g, c in V3_CASES],
)
def test_v3_decoder_token_exact(setup, B, greedy, span_cap):
    """The port's default kernel loop (v3, its twin on the CPU) against
    JAX's v3 loop in interpret mode."""
    vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[:B], span_types[:B], n_spans[:B], no_whole[:B])
    kw = dict(max_tgt_len=L, span_cap=span_cap, greedy=greedy,
              nucleus_p=None if greedy else 0.9)
    rng = jax.random.PRNGKey(9)
    jdec = JDecoder(jmodel, vocab, fused=True, fused_sampling=True, interpret=True, **kw)
    want = jdec(params, *args, rng)
    noise = None if greedy else np.asarray(
        jax.random.gumbel(rng, (L, B, vocab_pad(vocab.vocab_size)), dtype=np.float32)
    )
    dec = InfillDecoder(tmodel, tvocab, fused=True, **kw)
    assert dec.fused_sampling is True  # fused_sampling=None follows fused
    got = dec(*args, noise=noise)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)


def test_v3_batch_of_three_equals_plain_loop(setup):
    """B=3, which the TPU kernel cannot take and the CUDA kernels can: the v3
    loop gives the plain loop's greedy tokens."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[:3], span_types[:3], n_spans[:3], no_whole[:3])
    kw = dict(max_tgt_len=L, span_cap=40, greedy=True, nucleus_p=None)
    want = InfillDecoder(tmodel, tvocab, fused=False, **kw)(*args)
    got = InfillDecoder(tmodel, tvocab, fused=True, **kw)(*args)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths.numpy())
    assert got.steps == want.steps


def test_max_tgt_len_beyond_max_len_raises(setup):
    _, tvocab, _, _, tmodel, _ = setup
    with pytest.raises(ValueError, match="positional limit"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=tmodel.cfg.max_len + 1)


@pytest.mark.parametrize("kw", [  # token_chunk and quant are ported: test_torch_decode_tokens/quant
    dict(draft_k=2), dict(draft_k=2, fused=True), dict(mesh=object()), dict(mesh=object(), fused=True),
])
def test_unported_options_raise(setup, kw):
    """The ids are kept from when these options raised.  ``draft_k`` is
    ported (tests/test_torch_spec_decode.py): a B=1 greedy call with it
    decodes the plain loop's tokens, on the plain and the fused verify.
    ``mesh`` is ported: a nucleus decode of 4 rows on a two-CPU mesh (its
    ``object()`` stands for the mesh) gives the unsharded decode's tokens,
    lengths and steps bit for bit, on the plain loop and on v3."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    if "draft_k" in kw:
        args = (src[:1], span_types[:1], n_spans[:1], no_whole[:1])
        common = dict(max_tgt_len=L, span_cap=24, greedy=True, nucleus_p=None)
        want = InfillDecoder(tmodel, tvocab, fused=False, **common)(*args)
        got = InfillDecoder(tmodel, tvocab, **common, **kw)(*args)
        np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
        np.testing.assert_array_equal(got.lengths.numpy(), want.lengths.numpy())
        return
    from smer_music_generation_tpu_torch.parallel.mesh import make_mesh

    args = (src, span_types, n_spans, no_whole)
    common = dict(max_tgt_len=L, span_cap=24, nucleus_p=0.9, fused=kw.get("fused", False), seed=3)
    want = InfillDecoder(tmodel, tvocab, **common)(*args)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    got = InfillDecoder(tmodel, tvocab, mesh=mesh, **common)(*args)
    assert mesh.shape == {"dp": 2, "tp": 1}
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths.numpy())
    assert got.steps == want.steps


def test_forced_prefix_raises(setup):
    """A forced prefix runs on the plain loop only (its parity with JAX is
    in ``tests/test_torch_eval.py``): the kernel loops (v2, v3, v4) raise
    on it, as JAX's fused decoder does, and the plain loop reproduces it."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[:1], span_types[:1], n_spans[:1], no_whole[:1])
    forced = np.full((1, 4), tvocab.mask_index, np.int32)
    kw = dict(max_tgt_len=L, span_cap=12, greedy=True, nucleus_p=None)
    for loop in (dict(fused_sampling=False), dict(), dict(token_chunk=8)):
        dec = InfillDecoder(tmodel, tvocab, fused=True, **kw, **loop)
        with pytest.raises(ValueError, match="fused=False"):
            dec(*args, forced=forced, forced_len=np.asarray([3]))
    got = InfillDecoder(tmodel, tvocab, fused=False, **kw)(*args, forced=forced, forced_len=np.asarray([3]))
    np.testing.assert_array_equal(got.tokens.numpy()[0, :3], forced[0, :3])


def test_decoder_defaults_to_plain_loop_on_cpu(setup):
    _, tvocab, _, _, tmodel, _ = setup
    assert InfillDecoder(tmodel, tvocab, max_tgt_len=L).fused is False


def test_fused_decoder_refuses_what_the_kernel_cannot_take(setup):
    """The kernel loop never gives way to the plain loop by itself: a batch
    of more than 8, or a model whose heads the kernel cannot tile, raises."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    dec = InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, greedy=True, nucleus_p=None)
    nine = np.arange(9) % len(src)
    with pytest.raises(ValueError, match="at most 8"):
        dec(src[nine], span_types[nine], n_spans[nine], no_whole[nine])
    from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
    odd = ScoreTransformer(ModelConfig(vocab_size=tvocab.vocab_size, d_model=96, nhead=3,
                                       num_encoder_layers=1, num_decoder_layers=1, d_ff=64))
    with pytest.raises(ValueError, match="fused=False"):
        InfillDecoder(odd, tvocab, max_tgt_len=L, fused=True)
    assert InfillDecoder(odd, tvocab, max_tgt_len=L, fused=False).fused is False

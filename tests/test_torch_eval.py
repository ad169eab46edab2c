"""The port's evaluation path against the JAX package's, on the CPU.

Same weights (a tiny model, JAX init, carried over by ``params_from_flax``),
same serving stream (the two-track test score in the control-mode-2 layout).
JAX draws decode ``i`` of a settle loop from ``fold_in(rng, i)``; the port
draws from its generator in decode order, so the tests hand the port's
plain-loop decoder that same Gumbel noise, ``jax.random.gumbel(fold_in(rng,
i), (L, B, V))``, and the results must be token-exact:

* the forced-prefix plain loop (greedy and nucleus, B = 1 and 2);
* ``run_with_span_retries`` and ``run_with_correct_controls`` (every
  ``InfillResult`` field, per-span retry counts included);
* post-hoc ``correct_controls=True`` (greedy, plain and v3 twin loops);
* ``ControllabilityEvaluator.run`` under greedy engines, every kind, unk
  modes 0-3 and the in-decode mode;
* ``eval_cli`` end to end with ``--device cpu``.
"""

import json

import jax
import numpy as np
import pytest

from smer_music_generation_tpu.eval.controllability import (
    ControllabilityEvaluator as JEvaluator,
)
from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.infer.engine import InfillEngine as JEngine
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.eval.controllability import ControllabilityEvaluator
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, serving_events

L = 512
TINY = dict(d_model=64, nhead=1, num_encoder_layers=1, num_decoder_layers=1, d_ff=64)  # the v3 twin takes it


@pytest.fixture(scope="module")
def setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    tvocab = TWordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=3, **TINY)
    return vocab, tvocab, jmodel, params, tmodel, serving_events(tvocab)


def gumbel(rng, B, V):
    return np.asarray(jax.random.gumbel(rng, (L, B, V), dtype=np.float32))


class FoldInNoise:
    """The port's eval decoder with decode ``i`` given JAX's noise for
    ``fold_in(rng, i)``; every other attribute is the decoder's."""

    def __init__(self, decoder, rng, V):
        self.decoder, self.rng, self.V, self.calls = decoder, rng, V, 0

    def __getattr__(self, name):
        return getattr(self.decoder, name)

    def __call__(self, *args, **kw):
        noise = gumbel(jax.random.fold_in(self.rng, self.calls), 1, self.V)
        self.calls += 1
        return self.decoder(*args, noise=noise, **kw)


def engines(setup, greedy=False, attempts=2, fused=False):
    vocab, tvocab, jmodel, params, tmodel, _ = setup
    kw = dict(nucleus_p=None if greedy else 0.9, greedy=greedy, max_tgt_len=L,
              max_time_fix_attempts=attempts)
    return JEngine(jmodel, params, vocab, **kw), InfillEngine(tmodel, tvocab, fused=fused, **kw)


# one engine pair a mode for the whole file, so JAX compiles each loop once
@pytest.fixture(scope="module")
def nucleus_engines(setup):
    return engines(setup, attempts=1)


@pytest.fixture(scope="module")
def greedy_engines(setup):
    return engines(setup, greedy=True)


FORCED_CASES = [(1, True), (1, False), (2, True), (2, False)]


@pytest.mark.parametrize("B,greedy", FORCED_CASES,
                         ids=[f"B{b}-{'greedy' if g else 'nucleus'}" for b, g in FORCED_CASES])
def test_forced_prefix_token_exact(setup, B, greedy):
    """Each row forced through a prefix of a JAX decode (the first spans,
    the second row also with a terminating m_0) reproduces it, and the
    port's plain loop equals JAX's forced loop token for token after it."""
    vocab, tvocab, jmodel, params, tmodel, events = setup
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, fused=False)
    reqs = [eng.prepare(events, [0], [1, 2]), eng.prepare(events, [1], [3])][:B]
    src, span_types, n_spans, no_whole, _ = eng._assemble(reqs)
    kw = dict(max_tgt_len=L, greedy=greedy, nucleus_p=None if greedy else 0.9)
    jdec = JDecoder(jmodel, vocab, fused=False, **kw)
    full = np.asarray(jdec(params, src, span_types, n_spans, no_whole, jax.random.PRNGKey(3)).tokens)
    forced_len = np.zeros(B, np.int32)
    for b in range(B):
        m0 = np.flatnonzero(full[b] == vocab.mask_index)
        assert len(m0) >= 3
        forced_len[b] = m0[2] if b == 0 else m0[1] + 1  # row 1 ends on a forced m_0
    forced = np.where(np.arange(forced_len.max()) < forced_len[:, None],
                      full[:, : forced_len.max()], 0)
    rng = jax.random.PRNGKey(99)  # other noise: the suffix may differ from the first decode
    want = jdec(params, src, span_types, n_spans, no_whole, rng, forced=forced, forced_len=forced_len)
    dec = InfillDecoder(tmodel, tvocab, fused=False, **kw)
    got = dec(src, span_types, n_spans, no_whole, forced=forced, forced_len=forced_len,
              noise=None if greedy else gumbel(rng, B, vocab.vocab_size))
    toks = got.tokens.numpy()
    for b in range(B):
        np.testing.assert_array_equal(toks[b, : forced_len[b]], forced[b, : forced_len[b]])
        assert int((toks[b] == vocab.mask_index).sum()) == n_spans[b]
    np.testing.assert_array_equal(toks, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


SETTLE_CASES = [("run_with_span_retries", [0], [1, 2], 7), ("run_with_span_retries", [0, 1], [4], 1),
                ("run_with_correct_controls", [1], [3, 5], 4)]


@pytest.mark.parametrize("method,tracks,bars,seed", SETTLE_CASES,
                         ids=[f"{m.split('_')[-1]}-tracks{t}-bars{b}" for m, t, b, _ in SETTLE_CASES])
def test_settle_loop_matches_jax(setup, nucleus_engines, method, tracks, bars, seed):
    """The settle loop under JAX's fold_in noise equals JAX's field by
    field; random weights close few bars, so groups retry."""
    vocab, events = setup[0], setup[-1]
    jeng, eng = nucleus_engines
    rng = jax.random.PRNGKey(seed)
    want = getattr(jeng, method)(jeng.prepare(events, tracks, bars), rng)
    eng._eval_decoder_cache = FoldInNoise(getattr(eng._eval_decoder, "decoder", eng._eval_decoder),
                                          rng, vocab.vocab_size)
    got = getattr(eng, method)(eng.prepare(events, tracks, bars))
    assert got.generated == want.generated
    assert got.events == want.events
    assert got.time_corrections_per_span == want.time_corrections_per_span
    assert got.time_failed_per_span == want.time_failed_per_span
    assert (got.time_corrections, got.time_failed, got.decode_steps) == (
        want.time_corrections, want.time_failed, want.decode_steps)
    assert max(got.time_corrections_per_span) >= 1  # at least one group retried
    assert eng._eval_decoder.calls >= 2


def test_call_dispatches_to_the_settle_loop(setup):
    """``__call__(span_retries=True)`` and ``correct_controls="in_decode"``
    run the settle loop (per-span counts) and restore the stream."""
    eng = engines(setup, attempts=1)[1]
    events = setup[-1]
    for kw in (dict(span_retries=True), dict(correct_controls="in_decode"),
               dict(span_retries=True, correct_controls=True)):
        res = eng(events, [0], [3], **kw)
        assert res.time_corrections_per_span is not None and "m_0" not in res.events


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "v3"])
def test_post_hoc_correct_controls_matches_jax(setup, greedy_engines, fused):
    jeng = greedy_engines[0]
    eng = greedy_engines[1] if not fused else engines(setup, greedy=True, fused=True)[1]
    events = setup[-1]
    want = jeng(events, [0, 1], [2, 6], jax.random.PRNGKey(0), correct_controls=True)
    got = eng(events, [0, 1], [2, 6], correct_controls=True)
    assert got.generated == want.generated
    assert got.events == want.events
    plain = eng(events, [0, 1], [2, 6])
    assert plain.generated == got.generated and plain.events != got.events  # controls rewritten


EVAL_CASES = [(0, False), (1, False), (2, False), (3, False), (0, True)]


@pytest.mark.parametrize("unk_mode,in_decode", EVAL_CASES,
                         ids=[f"unk{u}{'-in_decode' if c else ''}" for u, c in EVAL_CASES])
def test_evaluator_matches_jax(setup, greedy_engines, unk_mode, in_decode):
    """Greedy engines in both packages: every kind's diff list, failures
    and secondary families, and the time stats, are equal."""
    vocab, tvocab = setup[0], setup[1]
    jeng, eng = greedy_engines
    events = setup[-1]
    # 4 complete bars (2 in the in-decode mode, whose substitutions replay)
    windows = [events[: [i for i, t in enumerate(events) if t == "bar"][2 if in_decode else 4]]]
    kinds = ("tensile", "density", "occupation", "polyphony")
    want = JEvaluator(jeng, vocab, unk_mode=unk_mode, correct_controls=in_decode).run(
        windows, control_kinds=kinds, seed=2)
    got = ControllabilityEvaluator(eng, tvocab, unk_mode=unk_mode, correct_controls=in_decode).run(
        windows, control_kinds=kinds, seed=2)
    assert got == want
    assert sum(got[k]["n"] for k in kinds) >= 1


def test_eval_cli_end_to_end(tmp_path):
    """``eval_cli.main --device cpu`` on a tiny random model over one stored
    window (leading copies only): every kind decoded once
    (``--max_time_fix_attempts 0``), the JSON schema of JAX's CLI."""
    from smer_music_generation_tpu_torch.codec.annotate import encode_midi
    from smer_music_generation_tpu_torch.data.pack import save_batches
    from smer_music_generation_tpu_torch.eval import eval_cli
    from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
    from tests.test_annotate import make_two_track_score

    events, _ = encode_midi(make_two_track_score(), controls={"key": None},
                            track_names=["track_0", "track_1"])
    window = [str(t) for t in events]
    prefix = str(tmp_path / "tiny_test")
    save_batches([[window]], {len(window): [0]}, prefix)
    cfg_path = str(tmp_path / "config.json")
    ExperimentConfig(d_model=32, nhead=4, num_layers=1, d_ff=64).save(cfg_path)
    out = str(tmp_path / "eval.json")
    rc = eval_cli.main(["--device", "cpu", "--config", cfg_path, "--test_batches", prefix,
                        "--max_windows", "1", "--seed", "0", "--output", out,
                        "--max_time_fix_attempts", "0"])
    assert rc == 0
    with open(out) as f:
        results = json.load(f)
    kinds = [k for k in ("tensile", "density", "occupation", "polyphony") if k in results]
    assert kinds == ["tensile", "density", "occupation", "polyphony"]
    assert "time_stats" in results and any(results[k]["n"] >= 1 for k in kinds)
    assert all(results[k]["mean_abs_diff"] >= 0 for k in kinds if results[k]["n"])

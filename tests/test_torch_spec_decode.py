"""Speculative decode (``draft_k > 0``): the port's sampler step, decoder
loop, engine and entry points against the JAX package, on the CPU.

Same small model in both packages (d_model 128, 2 heads of 64, 2 layers,
d_ff 256, f32, JAX init with random biases and LayerNorms), same B=1
requests (serving streams of the two-track test score, masked by the port's
engine).  JAX's decoder runs its v5 loop with the XLA verify
(``fused=False``: ``decode_window``) or with the Pallas verify in interpret
mode (``interpret=True``); the port runs ``decode_window`` (``fused=False``)
or the twin of its verify kernel (``fused=True``).  For nucleus sampling
JAX's own draws, ``split(rng)`` into ``gumbel (L, V)`` and ``uniform (L,)``,
are handed to the port.

Tolerances: none.  Tokens, lengths and step counts are compared exactly,
as ``spec_accept_resample``'s tokens and acceptance flags on equal inputs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.infer.engine import InfillEngine as JEngine
from smer_music_generation_tpu.infer.sampling import spec_accept_resample as jspec
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.infer.sampling import spec_accept_resample
from smer_music_generation_tpu_torch.ops import decode_graph as dg
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, serving_events

L = 512


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=91 + mode)
    events = serving_events(tvocab)
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, fused=False)
    reqs = [eng.prepare(events, [0], [1, 2]), eng.prepare(events, [1], [5, 6, 7])]
    src, span_types, n_spans, no_whole, _ = eng._assemble(reqs)
    return vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole)


@pytest.fixture
def verify_windows(monkeypatch):
    """The window sizes of every fused verify the decoder calls, its own
    and those of the ``SpecGraph`` its fused loop steps."""
    seen = []
    inner = decode_mod.fused_verify_window

    def spy(packed, x_emb, *a, **k):
        seen.append(x_emb.shape[0])
        return inner(packed, x_emb, *a, **k)

    monkeypatch.setattr(decode_mod, "fused_verify_window", spy)
    monkeypatch.setattr(dg, "fused_verify_window", spy)
    return seen


@pytest.mark.parametrize("p,temperature", [(0.9, 1.0), (None, 0.7), (0.5, 1.3)])
def test_spec_accept_resample_equals_jax(p, temperature):
    """Same u, Gumbel rows, logits, mask and draft: the same tokens and
    acceptance flags, including drafts the mask bans and drafts that carry
    all of the kept mass."""
    rng = np.random.default_rng(17)
    B, V = 64, 309
    logits = rng.normal(0, 2.0, (B, V)).astype(np.float32)
    allowed = rng.random((B, V)) < 0.5
    draft = rng.integers(0, V, size=B).astype(np.int32)
    allowed[np.arange(B) % 3 == 0, draft[np.arange(B) % 3 == 0]] = True
    allowed[5] = False
    allowed[5, draft[5]] = True  # the draft alone is allowed: accepted for sure
    u = rng.random(B).astype(np.float32)
    g = rng.gumbel(size=(B, V)).astype(np.float32)
    want_tok, want_acc = jspec(jnp.asarray(u), jnp.asarray(g), jnp.asarray(logits),
                               jnp.asarray(allowed), jnp.asarray(draft), p, temperature)
    got_tok, got_acc = spec_accept_resample(
        torch.from_numpy(u), torch.from_numpy(g), torch.from_numpy(logits),
        torch.from_numpy(allowed), torch.from_numpy(draft), p, temperature)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    assert bool(got_acc[5]) and 0 < int(got_acc.sum()) < B


SPEC_CASES = [  # (request, draft_k, greedy, JAX verify, port fused, span_cap)
    (0, 4, True, "xla", False, 40),
    (1, 8, True, "xla", True, 100),
    (0, 8, True, "kernel", True, 40),
    (1, 4, False, "xla", False, 40),
    (0, 8, False, "kernel", True, 40),
    (1, 15, False, "xla", True, 40),
    (0, 17, True, "xla", True, 40),  # a window of 18 rows: two row-vector launches on the card
]


@pytest.mark.parametrize(
    "req,k,greedy,jax_verify,fused,span_cap", SPEC_CASES,
    ids=[f"req{r}-k{k}-{'greedy' if g else 'nucleus'}-jax_{j}-{'fused' if f else 'plain'}-cap{c}"
         for r, k, g, j, f, c in SPEC_CASES],
)
def test_v5_token_exact_with_jax(setup, verify_windows, req, k, greedy, jax_verify, fused, span_cap):
    vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[req : req + 1], span_types[req : req + 1], n_spans[req : req + 1],
            no_whole[req : req + 1])
    kw = dict(max_tgt_len=L, span_cap=span_cap, greedy=greedy, nucleus_p=None if greedy else 0.9,
              draft_k=k)
    rng = jax.random.PRNGKey(13 + req)
    jdec = JDecoder(jmodel, vocab, fused=False, interpret=jax_verify == "kernel", **kw)
    want = jdec(params, *args, rng)
    draws = {}
    if not greedy:  # JAX v5's own draws (infer/decode.py:495-497)
        g_rng, u_rng = jax.random.split(rng)
        draws = dict(noise=np.asarray(jax.random.gumbel(g_rng, (L, vocab.vocab_size), dtype=jnp.float32)),
                     uniforms=np.asarray(jax.random.uniform(u_rng, (L,), dtype=jnp.float32)))
    dec = InfillDecoder(tmodel, tvocab, fused=fused, **kw)
    got = dec(*args, **draws)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)
    if fused:  # every verify went through the kernel's wrapper, W = k + 1 or a tail row
        assert verify_windows and set(verify_windows) <= {k + 1, 1}
        assert verify_windows[0] == k + 1
    else:
        assert not verify_windows


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("k", [3, 8])
def test_v5_greedy_equals_the_plain_loop(setup, fused, k):
    """Greedy speculative decode emits the plain loop's tokens (the same
    argmax chain, verified W rows at a time), for each request."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    kw = dict(max_tgt_len=L, span_cap=40, greedy=True, nucleus_p=None)
    base = InfillDecoder(tmodel, tvocab, fused=False, **kw)
    spec = InfillDecoder(tmodel, tvocab, fused=fused, draft_k=k, **kw)
    for r in range(len(src)):
        args = (src[r : r + 1], span_types[r : r + 1], n_spans[r : r + 1], no_whole[r : r + 1])
        want, got = base(*args), spec(*args)
        n = int(want.lengths[0])
        assert int(got.lengths[0]) == n
        np.testing.assert_array_equal(got.tokens[0, :n].numpy(), want.tokens[0, :n].numpy())


def test_v5_fills_the_buffer_through_the_tail_loop(setup, verify_windows):
    """A session that hits the cap: the windowed loop stops draft_k
    positions short of it and the single-token tail fills the rest, as
    JAX's (and the plain loop, greedy) fill it."""
    vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole) = setup
    Lc, k = 128, 8
    args = (src[1:2], span_types[1:2], n_spans[1:2], no_whole[1:2])
    kw = dict(max_tgt_len=Lc, span_cap=100, greedy=True, nucleus_p=None)
    want = JDecoder(jmodel, vocab, fused=False, draft_k=k, **kw)(params, *args, jax.random.PRNGKey(0))
    base = InfillDecoder(tmodel, tvocab, fused=False, **kw)(*args)
    for fused in (False, True):
        got = InfillDecoder(tmodel, tvocab, fused=fused, draft_k=k, **kw)(*args)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_array_equal(got.tokens.numpy(), base.tokens.numpy())
        assert int(got.lengths[0]) == int(want.lengths[0]) == Lc
        assert got.steps == int(want.steps) == Lc - 1
    assert 1 in verify_windows and verify_windows[0] == k + 1  # the tail ran


def test_v5_batched_call_takes_the_other_loops(setup, monkeypatch):
    """With draft_k set, a batch of several rows decodes through the v3
    loop (fused) or the plain loop, as in JAX; only B=1 takes v5."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    calls = []
    monkeypatch.setattr(InfillDecoder, "_decode_v5", lambda self, *a: calls.append(a))
    kw = dict(max_tgt_len=L, span_cap=12, greedy=True, nucleus_p=None)
    for fused in (False, True):
        got = InfillDecoder(tmodel, tvocab, fused=fused, draft_k=4, **kw)(src, span_types, n_spans, no_whole)
        want = InfillDecoder(tmodel, tvocab, fused=fused, **kw)(src, span_types, n_spans, no_whole)
        np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())
    assert calls == []


def test_draft_k_limits(setup):
    """Neither verify caps draft_k, as JAX's decoder does not: the fused
    one runs a window of more than 16 rows as row-vector launches of 16
    rows each, so draft_k 16 and 24 are accepted with and without
    ``fused``.  draft_k with int8 weights raises, as in JAX."""
    _, tvocab, _, _, tmodel, _ = setup
    for fused in (True, False):
        for k in (15, 16, 24):
            assert InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=fused, draft_k=k).draft_k == k
    with pytest.raises(ValueError, match="quantized"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, draft_k=4, quant="int8")


def test_engine_with_draft_k_equals_jax_engine(setup):
    """A greedy ``InfillEngine(draft_k=...)`` request: the JAX engine's
    events and step count, through the fused verify (its twin)."""
    vocab, tvocab, jmodel, params, tmodel, _ = setup
    events = serving_events(tvocab)
    kw = dict(greedy=True, nucleus_p=None, max_tgt_len=L, draft_k=6)
    want = JEngine(jmodel, params, vocab, **kw)(events, [0], [1, 2], jax.random.PRNGKey(0))
    before = ds.fused_verify_window_reference.calls
    got = InfillEngine(tmodel, tvocab, fused=True, **kw)(events, [0], [1, 2])
    assert ds.fused_verify_window_reference.calls > before
    assert got.generated == want.generated
    assert got.events == want.events
    assert got.decode_steps == want.decode_steps


def test_nucleus_engine_with_draft_k_restores(setup):
    """Nucleus spec decode through the engine (the generator's own draws,
    the bar-time retry loop): the result restores with its bar count."""
    _, tvocab, _, _, tmodel, _ = setup
    events = serving_events(tvocab)
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, draft_k=8, max_time_fix_attempts=2, seed=3)
    res = eng(events, [1], [2, 3])
    assert res is not None and res.decode_steps > 0 and "m_0" not in res.events
    assert sum(e == "bar" for e in res.events) == sum(e == "bar" for e in events)


def test_generate_cli_draft_k_writes_readable_midi(tmp_path, monkeypatch):
    """``generate_cli --draft_k`` decodes its request through v5."""
    from smer_music_generation_tpu_torch.codec.midi import read_midi
    from smer_music_generation_tpu_torch.infer import generate_cli
    from tests.test_annotate import make_two_track_score

    calls = []
    inner = InfillDecoder._decode_v5
    monkeypatch.setattr(InfillDecoder, "_decode_v5",
                        lambda self, *a: calls.append(self.draft_k) or inner(self, *a))
    midi_in = tmp_path / "in.mid"
    make_two_track_score().write(str(midi_in))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"d_model": 64, "nhead": 1, "num_layers": 1, "d_ff": 128}))
    out_path = tmp_path / "out.mid"
    rc = generate_cli.main([
        "--device", "cpu", "-i", str(midi_in), "-o", str(out_path), "--bars", "1",
        "--tracks", "0", "--config", str(cfg_path), "--seed", "3", "--max_tgt", "256",
        "--draft_k", "5",
    ])
    assert rc == 0 and calls and set(calls) == {5}
    decoded = read_midi(str(out_path))
    assert decoded.instruments and sum(len(i.notes) for i in decoded.instruments) > 0


def test_serve_cli_draft_k_serves_through_v5(monkeypatch, tmp_path):
    """``serve_cli --draft_k`` builds its serving context with the option,
    and a /generate on that context decodes through v5."""
    from smer_music_generation_tpu_torch.serve import serve_cli
    from tests.test_serve import plugin_payload

    made = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def shutdown(self):
            made["shutdown"] = True

        def server_close(self):
            pass

    def fake_serve(ctx, host, port):
        made["ctx"] = ctx
        return Server()

    def stop(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_cli, "serve", fake_serve)
    monkeypatch.setattr(serve_cli.time, "sleep", stop)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"d_model": 64, "nhead": 1, "num_layers": 1, "d_ff": 128}))
    rc = serve_cli.main(["--device", "cpu", "--config", str(cfg_path), "--checkpoint", "random",
                         "--draft_k", "4", "--batch_window_ms", "0"])
    assert rc == 0 and made["shutdown"]
    ctx = made["ctx"]
    assert ctx.engine.decoder.draft_k == 4
    calls = []
    inner = InfillDecoder._decode_v5
    monkeypatch.setattr(InfillDecoder, "_decode_v5",
                        lambda self, *a: calls.append(1) or inner(self, *a))
    enc = ctx.handle_encode({"notes": plugin_payload(), "controls": {"start_bar": 1}})
    controls = dict(enc["controls"], bar_track=0, start_bar=1)
    for n in (0, 1):
        controls[f"track_{n}_c"], controls[f"track_{n}"] = controls[f"track_{n}"], 0
    ans = ctx.handle_generate({"events": enc["events"], "controls": controls, "tracks": [0],
                               "bars": [1], "tempo": 100})
    assert calls and "m_0" not in ans["events"] and ans["decode_steps"] > 0

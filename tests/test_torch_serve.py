"""The port's serving layer (``serve/protocol.py``, ``serve/app.py``,
``serve/serve_cli.py``) against the JAX package's, on the CPU.

The protocol helpers and ``/encode`` are host code: their results must be
equal to JAX's on the same payloads.  ``/generate`` under greedy decoding
must give JAX's events when both contexts' engines hold the same weights.
The ``MicroBatcher`` is checked with a fake engine, as
``tests/test_serve.py`` checks JAX's.  No tolerance is used: every
comparison is exact.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

from smer_music_generation_tpu.infer.engine import InfillEngine as JEngine
from smer_music_generation_tpu.serve import protocol as jprotocol
from smer_music_generation_tpu.serve.app import ServingContext as JServingContext
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.serve import protocol
from smer_music_generation_tpu_torch.serve import serve_cli
from smer_music_generation_tpu_torch.serve.app import MicroBatcher, ServingContext, serve
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.test_serve import plugin_payload
from tests.torch_port_helpers import model_pair


def _notes(score):
    return [
        (inst.program, inst.is_drum, [(n.velocity, n.pitch, n.start, n.end) for n in inst.notes])
        for inst in score.instruments
    ]


def _sparse(payload):
    return {
        "tempo": payload["tempo"], "numerator": payload["numerator"],
        "denominator": payload["denominator"],
        "track_1": payload["track_0"], "track_1_program": payload["track_0_program"],
        "track_3": payload["track_1"], "track_3_program": payload["track_1_program"],
    }


def _json(x):
    return json.loads(json.dumps(x))


def _unlocked(controls, tracks=(0, 1)):
    """The plugin's overwrite before /generate: per-track control dicts move
    to ``track_N_c``, ``track_N`` becomes the lock flag 0 (unlocked), and
    the window starts at plugin bar 1."""
    controls = dict(controls)
    controls["bar_track"] = 0
    controls["start_bar"] = 1
    for n in tracks:
        controls[f"track_{n}_c"] = controls[f"track_{n}"]
        controls[f"track_{n}"] = 0
    return controls


@pytest.mark.parametrize("start_bar", [1, 3])
def test_protocol_copies_equal_jax(start_bar):
    for data in (plugin_payload(), _sparse(plugin_payload(bars=8))):
        want = jprotocol.note_midi(data, start_bar)
        got = protocol.note_midi(data, start_bar)
        assert _notes(got) == _notes(want)
        names = [f"track_{i}" for i in range(len(got.instruments))]
        controls = {"start_bar": start_bar, "s_bar": start_bar + 1, "e_bar": start_bar + 4,
                    "track_0": 0, "track_1": 1}
        assert (protocol.midi2notes(got, 100.0, names, controls)
                == jprotocol.midi2notes(want, 100.0, names, controls))
    total, partial = (protocol.note_midi(plugin_payload(8), 1) for _ in range(2))
    jtotal, jpartial = (jprotocol.note_midi(plugin_payload(8), 1) for _ in range(2))
    for p in (partial, jpartial):
        for n in p.instruments[0].notes:
            n.pitch += 1
    window = {"start_bar": 1, "s_bar": 2, "e_bar": 3}
    assert (_notes(protocol.merge_pm(total, partial, window, 4, 4, 100.0))
            == _notes(jprotocol.merge_pm(jtotal, jpartial, window, 4, 4, 100.0)))


@pytest.fixture(scope="module")
def contexts():
    """A JAX and a port context on the same small model (f32, CPU), both
    without the batcher, their engines greedy; the port's decodes through
    its v3 kernel loop (the twin on the CPU)."""
    vocab = WordVocab(0, CONTROL_SETS[5])
    tvocab = TWordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=51)
    jctx = JServingContext(jmodel, params, vocab, batch_window_ms=0)
    jctx.engine = JEngine(jmodel, params, vocab, greedy=True, nucleus_p=None)
    tctx = ServingContext(tmodel, tvocab, batch_window_ms=0)
    tctx.engine = InfillEngine(tmodel, tvocab, greedy=True, nucleus_p=None, fused=True)
    return jctx, tctx


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_encode_equals_jax(contexts, sparse):
    jctx, tctx = contexts
    notes = _sparse(plugin_payload()) if sparse else plugin_payload()
    payload = {"notes": notes, "controls": {"start_bar": 1}}
    got = _json(tctx.handle_encode(payload))
    assert got == _json(jctx.handle_encode(payload))
    assert got["controls"]["track_nums"] == 2
    want_map = ({"track_1": "track_0", "track_3": "track_1"} if sparse
                else {"track_0": "track_0", "track_1": "track_1"})
    assert got["track_map"] == want_map


def test_greedy_generate_equals_jax(contexts):
    jctx, tctx = contexts
    enc = tctx.handle_encode({"notes": plugin_payload(), "controls": {"start_bar": 1}})
    payload = {"events": enc["events"], "controls": _unlocked(enc["controls"]),
               "tracks": [0], "bars": [2, 3], "tempo": 100}
    want = _json(jctx.handle_generate(_json(payload)))
    got = _json(tctx.handle_generate(_json(payload)))
    assert got["events"] == want["events"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["notes"] == want["notes"]
    assert "m_0" not in got["events"] and "track_0" in got["notes"]


@pytest.fixture(scope="module")
def server_url():
    """The port's HTTP server on a tiny random model on the CPU, with the
    micro-batcher on (its default window)."""
    vocab = TWordVocab(0, CONTROL_SETS[5])
    torch.manual_seed(0)
    model = ScoreTransformer(ModelConfig(
        vocab_size=vocab.vocab_size, d_model=32, nhead=4, num_encoder_layers=1,
        num_decoder_layers=1, d_ff=64, max_len=2048,
    )).eval().requires_grad_(False)
    ctx = ServingContext(model, vocab)
    server = serve(ctx, host="127.0.0.1", port=0)
    host, port = server.server_address
    try:
        yield f"http://{host}:{port}"
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()
        assert not ctx.batcher._thread.is_alive()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_http_health(server_url):
    with urllib.request.urlopen(server_url + "/health", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body == {"status": "ok", "vocab_size": 309}


def test_http_encode_then_generate(server_url):
    enc = _post(server_url + "/encode", {"notes": plugin_payload(), "controls": {"start_bar": 1}})
    assert enc["controls"]["track_nums"] == 2
    gen = _post(server_url + "/generate", {
        "events": enc["events"], "controls": _unlocked(enc["controls"]),
        "tracks": [0], "bars": [1, 2], "tempo": 100,
    })
    assert "m_0" not in gen["events"] and gen["decode_steps"] > 0
    assert "track_0" in gen["notes"]
    bad = urllib.request.Request(server_url + "/generate", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(bad, timeout=30)
    assert err.value.code == 400


def test_next_rng_gives_each_request_its_own_generator(contexts):
    _, tctx = contexts
    a, b = tctx.next_rng(), tctx.next_rng()
    assert isinstance(a, torch.Generator) and a.initial_seed() + 1 == b.initial_seed()


# ---------------------------------------------------------------------------
# MicroBatcher, with a fake engine
# ---------------------------------------------------------------------------


class _CountingEngine:
    """run_batch stub: records group sizes, returns one result per request;
    a group holding a request named in ``bad`` fails as a whole."""

    def __init__(self, bad=()):
        self.calls = []
        self.bad = set(bad)
        self._lock = threading.Lock()

    def run_batch(self, requests, rng):
        with self._lock:
            self.calls.append(len(requests))
        if self.bad & set(requests):
            raise RuntimeError("device exploded")
        time.sleep(0.01)
        return [("ok", r) for r in requests]


def _submit_all(batcher, names):
    results, errors = {}, {}

    def worker(name):
        try:
            results[name] = batcher.submit(name, rng=None)
        except RuntimeError as exc:
            errors[name] = exc

    threads = [threading.Thread(target=worker, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_micro_batcher_coalesces_concurrent_requests():
    engine = _CountingEngine()
    batcher = MicroBatcher(engine, max_batch=8, window_ms=250.0)
    try:
        results, errors = _submit_all(batcher, [f"req{i}" for i in range(4)])
    finally:
        batcher.close()
    assert not errors
    assert results == {f"req{i}": ("ok", f"req{i}") for i in range(4)}
    assert engine.calls == [4]  # one decode for all four (the window is generous)
    assert not batcher._thread.is_alive()


def test_micro_batcher_caps_group_size():
    engine = _CountingEngine()
    batcher = MicroBatcher(engine, max_batch=2, window_ms=250.0)
    try:
        results, errors = _submit_all(batcher, [f"r{i}" for i in range(4)])
    finally:
        batcher.close()
    assert len(results) == 4 and not errors
    assert sum(engine.calls) == 4 and max(engine.calls) <= 2


def test_micro_batcher_isolates_a_failing_request():
    """A failed group is retried one request at a time: the bad request's
    caller gets the error, its neighbours their results."""
    engine = _CountingEngine(bad={"bad"})
    batcher = MicroBatcher(engine, max_batch=8, window_ms=250.0)
    try:
        results, errors = _submit_all(batcher, ["a", "bad", "b"])
    finally:
        batcher.close()
    assert results == {"a": ("ok", "a"), "b": ("ok", "b")}
    assert set(errors) == {"bad"} and "device exploded" in str(errors["bad"])
    assert engine.calls == [3, 1, 1, 1]


# the ids keep the ROADMAP numbers these items had when the test was
# written, so each case stays matched to its earlier runs; the check reads
# the current numbers
@pytest.mark.parametrize("flags,item", [
    (["--dp", "2"], "Queue 1 item 11"),
    (["--draft_k", "1"], None),
], ids=["flags0-Queue 1 item 8", "flags1-Queue 2 item 4"])
def test_serve_cli_refuses_unported_options(flags, item, monkeypatch, tmp_path):
    """The ids are kept from when both options raised.  ``--dp`` is ported:
    ``--dp 2`` on a host with fewer devices (the CPU is one) logs the error
    and returns 1, as JAX's CLI does, before it loads a model.
    ``--draft_k`` is ported: its case starts the CLI (its server and its
    wait stubbed) and finds the option on the serving context's decoder."""
    if item is not None:
        monkeypatch.setattr(serve_cli, "load_inference_model",
                            lambda *a, **k: pytest.fail("loaded a model"))
        assert serve_cli.main(["--device", "cpu", *flags]) == 1
        return
    made = []

    class Server:
        server_address = ("127.0.0.1", 0)

        def shutdown(self):
            pass

        def server_close(self):
            pass

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_cli, "serve", lambda ctx, host, port: made.append(ctx) or Server())
    monkeypatch.setattr(serve_cli.time, "sleep", interrupt)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"d_model": 32, "nhead": 1, "num_layers": 1, "d_ff": 64}))
    assert serve_cli.main(["--device", "cpu", "--config", str(cfg_path), *flags]) == 0
    assert made[0].engine.decoder.draft_k == 1


def test_serving_context_refuses_mesh_and_draft_k(contexts):
    """The name is kept from when ``mesh`` and ``draft_k`` raised.  Both are
    ported: a context built with either serves a greedy /generate with the
    events of the context without it (under a two-CPU mesh the one request
    is padded with a dummy to a row a shard)."""
    from smer_music_generation_tpu_torch.parallel.mesh import make_mesh

    _, tctx = contexts
    model = tctx.engine.model
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    sharded = ServingContext(model, tctx.vocab, mesh=mesh, batch_window_ms=0)
    assert sharded.engine.mesh is mesh and len(sharded.engine.decoder.shards) == 2
    sharded.engine = InfillEngine(model, tctx.vocab, greedy=True, nucleus_p=None, fused=True, mesh=mesh)
    spec = ServingContext(model, tctx.vocab, draft_k=2, batch_window_ms=0)
    assert spec.engine.decoder.draft_k == 2
    spec.engine = InfillEngine(model, tctx.vocab, greedy=True, nucleus_p=None, fused=True, draft_k=2)
    enc = tctx.handle_encode({"notes": plugin_payload(), "controls": {"start_bar": 1}})
    payload = {"events": enc["events"], "controls": _unlocked(enc["controls"]),
               "tracks": [1], "bars": [2], "tempo": 100}
    want = _json(tctx.handle_generate(_json(payload)))
    for ctx in (spec, sharded):
        got = _json(ctx.handle_generate(_json(payload)))
        assert got["events"] == want["events"] and got["notes"] == want["notes"]

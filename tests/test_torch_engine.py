"""The port's InfillEngine and generate CLI on the CPU.

A greedy ``InfillEngine.__call__`` on a small model gives the same event
list as the JAX engine with identical weights; a 3-request ``run_batch``
on the kernel loop decodes as one batch of 3 (no padding rows) and equals
the requests decoded one by one;
the CLI writes a MIDI file that reads back.
"""

import json

import jax
import numpy as np
import pytest

from smer_music_generation_tpu.infer.engine import InfillEngine as JEngine
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.codec.durations import duration_table_for_signature
from smer_music_generation_tpu_torch.codec.structure import bar_with_track_positions
from smer_music_generation_tpu_torch.infer.engine import (
    InfillEngine,
    check_track_total_time,
)
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, serving_events


@pytest.fixture(scope="module")
def setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    tvocab = TWordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=31)
    return vocab, tvocab, jmodel, params, tmodel, serving_events(tvocab)


@pytest.mark.parametrize("fused", [False, True])
def test_greedy_call_matches_jax_engine(setup, fused):
    vocab, tvocab, jmodel, params, tmodel, events = setup
    kw = dict(greedy=True, nucleus_p=None, max_tgt_len=512)
    want = JEngine(jmodel, params, vocab, **kw)(events, [0], [1, 2], jax.random.PRNGKey(0))
    got = InfillEngine(tmodel, tvocab, fused=fused, **kw)(events, [0], [1, 2])
    assert got.generated == want.generated
    assert got.events == want.events
    assert got.decode_steps == want.decode_steps
    # the masked bodies close their bars after the repair
    table = duration_table_for_signature((4, 4), 60.0)
    _, _, bars = bar_with_track_positions(got.events)
    for bar in (1, 2):
        start, end = bars[bar][0]
        tensile = 1 if got.events[end - 1].startswith("s_") else 0
        ok, _ = check_track_total_time(got.events[start + 3 : end - 3 - tensile], table)
        assert ok


def test_run_batch_padded_to_four_equals_one_by_one(setup):
    """3 requests on the kernel loop decode as one batch of 3, with no
    padding rows, and equal the same requests decoded one by one.  The
    name is kept from when the engine padded such a batch to 4, so the
    test stays matched to its earlier results."""
    _, tvocab, _, _, tmodel, events = setup
    eng = InfillEngine(tmodel, tvocab, greedy=True, nucleus_p=None, max_tgt_len=512, fused=True)
    reqs = [eng.prepare(events, [0], [1]), eng.prepare(events, [1], [3]),
            eng.prepare(events, [0, 1], [6])]
    seen = []
    inner = eng._dispatch

    def spy(src_b, *rest):
        seen.append(src_b.shape[0])
        return inner(src_b, *rest)

    eng._dispatch = spy
    batched = eng.run_batch(reqs)
    assert seen == [3]
    for req, res in zip(reqs, batched):
        alone = eng.run_batch([req])[0]
        assert res.generated == alone.generated
        assert res.events == alone.events
        assert "m_0" not in res.events


def test_unported_engine_options_raise(setup):
    """The name is kept from when ``span_retries``, ``correct_controls``
    and ``mesh`` raised.  They run now: greedy ``span_retries`` takes
    ``run_batch`` as in JAX, and the post-hoc rewrite gives JAX's stream
    (their parity under noise is in ``tests/test_torch_eval.py``).  On a
    two-CPU mesh, four nucleus requests on v3 give the unsharded engine's
    results (the same global noise, sliced by rows), and so do three greedy
    ones on the plain loop, padded with one done-at-start dummy to two shards of two rows; a
    quantized engine with a mesh raises JAX's ValueError."""
    vocab, tvocab, jmodel, params, tmodel, events = setup
    kw = dict(greedy=True, nucleus_p=None, max_tgt_len=512)
    eng = InfillEngine(tmodel, tvocab, **kw)
    jeng = JEngine(jmodel, params, vocab, **kw)
    for opts in (dict(span_retries=True), dict(correct_controls=True)):
        got = eng(events, [0], [1], **opts)
        want = jeng(events, [0], [1], jax.random.PRNGKey(0), **opts)
        assert got.events == want.events and got.generated == want.generated
    from smer_music_generation_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, devices=["cpu", "cpu"])
    reqs = [eng.prepare(events, [0], [b]) for b in (1, 2, 3)] + [eng.prepare(events, [1], [2])]
    for n, kw in ((4, dict(nucleus_p=0.9, fused=True)), (3, dict(greedy=True, nucleus_p=None))):
        kw.update(max_tgt_len=512, max_time_fix_attempts=1, seed=4)
        want = InfillEngine(tmodel, tvocab, **kw).run_batch(reqs[:n])
        got = InfillEngine(tmodel, tvocab, mesh=mesh, **kw).run_batch(reqs[:n])
        assert [(r.events, r.generated) for r in got] == [(r.events, r.generated) for r in want]
    with pytest.raises(ValueError, match="quantized"):
        InfillEngine(tmodel, tvocab, mesh=mesh, quant="int8", fused=True)


def test_generate_cli_writes_readable_midi(tmp_path):
    from smer_music_generation_tpu_torch.codec.midi import read_midi
    from smer_music_generation_tpu_torch.infer import generate_cli
    from tests.test_annotate import make_two_track_score

    midi_in = tmp_path / "in.mid"
    make_two_track_score().write(str(midi_in))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"d_model": 64, "nhead": 1, "num_layers": 1, "d_ff": 128}))
    out_path = tmp_path / "out.mid"
    rc = generate_cli.main([
        "--device", "cpu", "-i", str(midi_in), "-o", str(out_path),
        "--bars", "1", "--tracks", "0", "--config", str(cfg_path),
        "--seed", "3", "--max_tgt", "256",
    ])
    assert rc == 0
    decoded = read_midi(str(out_path))
    assert decoded.instruments and sum(len(i.notes) for i in decoded.instruments) > 0
    assert np.isfinite(decoded.instruments[0].notes[0].start)


@pytest.mark.parametrize("flag", [["--correct_controls"], ["--draft_k", "4"]],
                         ids=["flag0-Queue 1 item 7", "flag1-Queue 1 item 4 / Queue 2 item 3"])
def test_generate_cli_refuses_unported_flags(tmp_path, flag):
    """Both flags are ported; each case, whose id is kept from when the flag
    raised naming its ROADMAP item, runs the CLI with it on a small random
    model and reads the MIDI file back (the rewrite's parity with JAX is
    ``test_unported_engine_options_raise``)."""
    from smer_music_generation_tpu_torch.codec.midi import read_midi
    from smer_music_generation_tpu_torch.infer import generate_cli
    from tests.test_annotate import make_two_track_score

    midi_in, out_path = tmp_path / "in.mid", tmp_path / "out.mid"
    make_two_track_score().write(str(midi_in))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"d_model": 64, "nhead": 1, "num_layers": 1, "d_ff": 128}))
    rc = generate_cli.main(["--device", "cpu", "-i", str(midi_in), "-o", str(out_path),
                            "--bars", "1", "--config", str(cfg_path), "--max_tgt", "256",
                            "--greedy", *flag])
    decoded = read_midi(str(out_path))
    assert rc == 0 and decoded.instruments
    assert sum(len(i.notes) for i in decoded.instruments) > 0

"""The port's native tokenizer core and host CLIs against the JAX package's.

* the C++ core (``native/``, built with g++ under ``build/native/``) gives
  the port's Python tokens and JAX's tokens, bar by bar and whole files;
* ``data/build_cli --pack`` of both packages on the same seeded MIDI files
  (written by the port's ``codec/midi`` writer) packs the same windows;
* ``features/tension_cli`` of both writes the same pickles and summary.
"""

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from smer_music_generation_tpu.codec import smer as jsmer
from smer_music_generation_tpu.codec.durations import get_duration_table as jget_table
from smer_music_generation_tpu.codec.midi import Note as JNote
from smer_music_generation_tpu.codec.midi import read_midi as jread_midi
from smer_music_generation_tpu_torch import native
from smer_music_generation_tpu_torch.codec import smer
from smer_music_generation_tpu_torch.codec.durations import get_duration_table
from smer_music_generation_tpu_torch.codec.midi import Instrument, MidiScore, Note, TimeSignature, read_midi
from smer_music_generation_tpu_torch.native.tokenizer import bar_notes_to_event_native

ROOT = Path(__file__).resolve().parents[1]


def random_bar(seed, tempo=100.0, with_cont=False):
    """One 4/4 bar of jittered notes and chords as (start, end, pitch,
    velocity) tuples, a note carried over from the bar before with
    ``with_cont`` (as ``tests/test_native.py`` draws them)."""
    rng = np.random.default_rng(seed)
    q = 60.0 / tempo
    sixteenth = q / 4
    notes, slot = [], 0
    while slot < 16:
        if rng.random() < 0.6:
            length = int(rng.integers(1, 7))
            start = max(slot * sixteenth + rng.normal(0, sixteenth / 12), 0.0)
            end = (slot + length) * sixteenth + rng.normal(0, sixteenth / 12)
            pitch = int(rng.integers(30, 100))
            notes.append((start, end, pitch, 100))
            if rng.random() < 0.4:
                notes.append((start, end, min(pitch + 3, 108), 100))
            slot += length
        else:
            slot += 1
    if with_cont:
        notes.insert(0, (0.0, 6 * q, 55, -1))
    notes.sort(key=lambda n: n[0])
    return notes, 4 * q, np.arange(5) * q


def port_score(seed, bars=8, tracks=2, tempo=100.0):
    """A seeded multi-track 4/4 score built with the port's MIDI classes."""
    rng = np.random.default_rng(seed)
    s = MidiScore(initial_tempo=tempo)
    s.time_signature_changes = [TimeSignature(4, 4, 0.0)]
    sixteenth = 60.0 / tempo / 4
    for t in range(tracks):
        inst = Instrument(program=[0, 32, 48][t % 3])
        for bar in range(bars):
            slot = 0
            while slot < 16:
                if rng.random() < 0.55:
                    length = min(int(rng.integers(1, 6)), 16 - slot)
                    start = (bar * 16 + slot) * sixteenth
                    pitch = int(rng.integers(40 + 10 * t, 80 + 10 * t))
                    inst.notes.append(Note(100, pitch, start, start + length * sixteenth))
                    if rng.random() < 0.3:
                        inst.notes.append(Note(100, pitch + 4, start, start + length * sixteenth))
                    slot += length
                else:
                    slot += 1
        s.instruments.append(inst)
    return s


def test_native_core_builds_under_build_native():
    assert native.load_library() is not None, native.BUILD_INFO
    path = Path(native.BUILD_INFO["path"])
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert not list((ROOT / "smer_music_generation_tpu_torch").rglob("*.so"))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_cont", [False, True])
def test_native_bar_matches_python_and_jax(seed, with_cont):
    notes, next_bar, beats = random_bar(seed, with_cont=with_cont)
    table, jtable = get_duration_table(0.6, (4, 4)), jget_table(0.6, (4, 4))
    md = table.minimum_difference

    def port_notes():
        return [Note(v, p, s, e) for s, e, p, v in notes]

    before = dict(native.tokenizer.CALLS)
    nat_tokens, nat_cont = bar_notes_to_event_native(port_notes(), 0.0, next_bar, beats, table, md)
    assert native.tokenizer.CALLS["bar"] == before["bar"] + 1
    py_tokens, py_cont = smer.bar_notes_to_event(port_notes(), 0.0, next_bar, beats, table, md)
    j_tokens, j_cont = jsmer.bar_notes_to_event(
        [JNote(v, p, s, e) for s, e, p, v in notes], 0.0, next_bar, beats, jtable, md)
    assert nat_tokens == py_tokens == j_tokens
    assert sorted(nat_cont) == sorted(py_cont) == sorted(j_cont)
    for p in py_cont:
        assert abs(nat_cont[p].end - py_cont[p].end) < 1e-9
        assert abs(nat_cont[p].end - j_cont[p].end) < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_native_score_matches_python_and_jax(tmp_path, seed):
    """Whole files: ``midi_to_events`` through the one-call-per-track core,
    through the port's Python loops, and JAX's, on the same MIDI file."""
    path = str(tmp_path / "s.mid")
    port_score(seed, bars=12, tracks=1 + seed % 3).write(path)
    before = native.tokenizer.CALLS["track"]
    nat = smer.midi_to_events(read_midi(path))
    assert native.tokenizer.CALLS["track"] > before
    smer.set_native_tokenizer(False)
    try:
        py = smer.midi_to_events(read_midi(path))
    finally:
        smer.set_native_tokenizer(True)
    want = jsmer.midi_to_events(jread_midi(path))
    assert nat is not None and want is not None
    assert nat[0] == py[0] == want[0]


@pytest.fixture(scope="module")
def midi_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("midi")
    for i in range(6):
        port_score(100 + i, bars=10, tracks=1 + i % 3).write(str(d / f"s{i}.mid"))
    return d


def test_build_cli_packs_what_jax_packs(midi_dir, tmp_path):
    from smer_music_generation_tpu.data import build_cli as jbuild_cli
    from smer_music_generation_tpu.data.pack import load_batches as jload
    from smer_music_generation_tpu_torch.data import build_cli
    from smer_music_generation_tpu_torch.data.pack import load_batches

    outs = {}
    for name, cli in (("port", build_cli), ("jax", jbuild_cli)):
        out = tmp_path / name
        assert cli.main(["-i", str(midi_dir), "-o", str(out), "--pack"]) == 0
        outs[name] = out
    assert "native tokenizer: loaded" in (outs["port"] / "build.log").read_text()
    n = 0
    for split in ("training", "validation", "test"):
        prefix = f"smer_{split}"
        have = sorted(p.name for p in outs["port"].glob(prefix + "*"))
        assert have == sorted(p.name for p in outs["jax"].glob(prefix + "*"))
        if not have:
            continue
        got, got_len = load_batches(str(outs["port"] / prefix))
        want, want_len = jload(str(outs["jax"] / prefix))
        assert [[list(map(str, w)) for w in g] for g in got] == \
            [[list(map(str, w)) for w in g] for g in want]
        assert {int(k): list(v) for k, v in got_len.items()} == {int(k): list(v) for k, v in want_len.items()}
        n += sum(len(g) for g in got)
    assert n > 0


def test_tension_cli_writes_what_jax_writes(midi_dir, tmp_path):
    from smer_music_generation_tpu.features import tension_cli as jtension_cli
    from smer_music_generation_tpu_torch.features import tension_cli

    runs = {}
    for name, cli in (("port", tension_cli), ("jax", jtension_cli)):
        out = tmp_path / name
        assert cli.main(["-i", str(midi_dir), "-o", str(out), "-k"]) == 0
        with open(out / "files_result.json") as fh:
            summary = {os.path.basename(k): v for k, v in json.load(fh).items()}
        runs[name] = out, summary
    (port_out, got), (jax_out, want) = runs["port"], runs["jax"]
    assert got == want and len(got) >= 3
    for stem in got:
        for ext in (".tension", ".diameter"):
            with open(port_out / (stem + ext), "rb") as a, open(jax_out / (stem + ext), "rb") as b:
                np.testing.assert_array_equal(pickle.load(a), pickle.load(b))

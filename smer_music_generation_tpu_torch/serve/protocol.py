"""Ableton-plugin wire protocol helpers.

A copy of ``smer_music_generation_tpu/serve/protocol.py`` (``note_midi``
:20, ``midi2notes`` :57, ``merge_pm`` :92) on the port's own MIDI model;
the module has no JAX in it, but the port imports nothing of the JAX
package.  These port the serving-side conversion functions the
Colab/Flask server used (reference ``encode.py:83-133`` ``note_midi``,
``:1317-1344`` ``midi2notes``, ``:1347-1373`` ``merge_pm``).  The wire
format is the plugin's note-dict JSON:

    {"tempo": .., "numerator": .., "denominator": ..,
     "track_0": [[pitch, start_beat, dur_beats], ..],
     "track_0_program": <program + 1 or 0 for absent>, ...}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..codec.midi import Instrument, MidiScore, Note, TimeSignature


def note_midi(data: Dict, start_bar: int, total_tracks: int = 5) -> Optional[MidiScore]:
    """Plugin note dict -> MidiScore, shifted so ``start_bar`` is t=0."""
    tempo = data["tempo"]
    numerator = data["numerator"]
    denominator = data["denominator"]
    bar_time = 4 * 60 / tempo * numerator / denominator
    shift_time = (start_bar - 1) * bar_time
    beat_time = 60 / tempo

    score = MidiScore(initial_tempo=tempo)
    score.time_signature_changes = [TimeSignature(numerator, denominator, 0.0)]

    for track_num in range(total_tracks):
        name = f"track_{track_num}"
        if name in data and data.get(name + "_program", 0) > 0:
            inst = Instrument(
                program=data[name + "_program"] - 1, is_drum=(track_num == 4)
            )
            for note in data[name]:
                if len(note) == 3:
                    pitch, start_beat, dur_beats = note
                    inst.notes.append(
                        Note(
                            velocity=100,
                            pitch=pitch,
                            start=start_beat * beat_time - shift_time,
                            end=(start_beat + dur_beats) * beat_time - shift_time,
                        )
                    )
            inst.notes.sort(key=lambda n: (n.start, n.end, n.pitch))
            score.instruments.append(inst)

    if not score.instruments:
        return None
    return score


def midi2notes(
    score: MidiScore, tempo: float, track_names: Sequence[str], controls: Dict
) -> Dict[str, List[Dict]]:
    """Extract regenerated notes (per unlocked track, inside the fill
    window) back into the plugin's beat-based dicts."""
    out: Dict[str, List[Dict]] = {name: [] for name in track_names}
    start_bar = controls["start_bar"]
    s_bar = controls["s_bar"] - start_bar
    e_bar = controls["e_bar"] - start_bar + 1
    sig = score.time_signature_changes[0]
    bar_beat = sig.numerator * 4 / sig.denominator
    shift_beat = bar_beat * (start_bar - 1)
    beat_time = 60 / tempo

    for track_num, inst in enumerate(score.instruments):
        if track_num >= len(track_names):
            break
        name = track_names[track_num]
        if controls.get(name) != 0:
            continue  # locked track: plugin keeps its own notes
        for note in inst.notes:
            start_beat = note.start / beat_time
            if s_bar < start_beat / bar_beat + 0.01 and start_beat / bar_beat < e_bar:
                if note.pitch == 1 and note.duration < 0.02:
                    continue  # reference placeholder notes
                out[name].append(
                    {
                        "pitch": note.pitch,
                        "start_time": start_beat + shift_beat,
                        "duration": note.duration / beat_time,
                    }
                )
    return out


def merge_pm(
    total: MidiScore,
    partial: MidiScore,
    controls: Dict,
    numerator: int,
    denominator: int,
    tempo: float,
) -> MidiScore:
    """Splice the infilled window's notes back into the full song.

    Conscious divergence: the reference computes the bar length as
    ``beat_time * numerator`` (``encode.py:1348-1353``), ignoring the
    denominator — inconsistent with its own ``note_midi`` (``:98``) and
    wrong for 6/8, where the splice window lands at 2x the real bar
    offset and deletes the wrong region.  Here all three protocol
    functions use ``numerator * 4 / denominator`` quarter-beats per bar
    (identical for the 2/4, 3/4, 4/4 paths the reference exercised).
    """
    beat_time = 60 / tempo
    bar_beats = numerator * 4 / denominator
    start_fill = beat_time * bar_beats * (controls["s_bar"] - 1)
    end_fill = beat_time * bar_beats * controls["e_bar"]
    partial_shift = (controls["start_bar"] - 1) * beat_time * bar_beats

    for track_num, track in enumerate(total.instruments):
        track.notes = [
            n
            for n in track.notes
            if n.pitch != 1 and not (start_fill - 0.01 < n.start < end_fill)
        ]
        if track_num < len(partial.instruments):
            for note in partial.instruments[track_num].notes:
                start = note.start + partial_shift
                end = note.end + partial_shift
                if note.pitch != 1 and start_fill <= start < end_fill:
                    track.notes.append(Note(note.velocity, note.pitch, start, end))
        track.notes.sort(key=lambda n: n.start)
    return total

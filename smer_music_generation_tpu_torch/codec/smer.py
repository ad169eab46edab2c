"""SMER codec: MIDI <-> event-token streams (rest-multi encoding, mode 0).

Reimplements, on top of this framework's own MIDI model, the two tokenizer
front-ends of the reference plus the shared event->MIDI virtual machine:

* :func:`midi_to_events_window` — the serving-side 16-bar window tokenizer
  (reference ``encode.py:1144-1314``): pads short input to 16 bars with
  ``unk`` + rest bars.
* :func:`midi_to_events` — the corpus tokenizer (reference
  ``preprocessing.py:519-715``): no padding, role-mapped track labels.
* :func:`events_to_midi` — the event VM (reference ``encode.py:297-534`` /
  ``preprocessing.py:962-1226``): fixed-width bars, ``rest`` advances the
  cursor, ``sep`` rewinds to the previous group start, ``continue`` extends
  the matching note of the previous bar.

Documented conscious divergences from the reference (SURVEY.md §2.6):

* notes zeroed out by :func:`grid_notes` (``start == -1``) are dropped
  before chord grouping instead of flowing through as degenerate groups;
* the final chord-group flush uses the same continue-first ordering as the
  mid-loop flush (the reference's trailing flush re-sorts continue and new
  notes together by pitch, ``encode.py:1089``);
* the degenerate one-downbeat fallback computes the true bar duration
  (``4*60/tempo*num/den``; the reference inverts tempo at
  ``encode.py:1159``);
* no fake pitch-1 marker notes are inserted into decoded MIDI (they exist
  in the reference only to coax ``pretty_midi`` into computing beats).

Host copy of ``smer_music_generation_tpu/codec/smer.py`` for the PyTorch port,
which imports nothing of the JAX package.  Tokenization dispatches to the
port's copy of the C++ core (``native/``) when it builds, as JAX's does, and
falls back to the Python loops otherwise; both give the same tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..vocab import (
    CONTROL_TOKENS,
    TEMPO_BINS,
    TRACK_0_RANGE,
    V0,
    V1,
    V2,
)
from .durations import DurationTable, get_duration_table
from .midi import Instrument, Lyric, MidiScore, Note, TimeSignature

SUPPORTED_SIGNATURES = [(4, 4), (2, 4), (3, 4), (6, 8)]

SERVING_VELOCITIES = (V0, V1)
CORPUS_VELOCITIES = (V0, V1, V2)

# exact token -> pitch map (all pitches the vocab can emit); avoids a
# regex fullmatch per body token in the events_to_midi hot loop
_PITCH_LOOKUP = {f"p_{i}": i for i in range(128)}


# ---------------------------------------------------------------------------
# Gridding
# ---------------------------------------------------------------------------


def grid_notes(
    beat_times: Sequence[float],
    notes: List[Note],
    minimum_difference: float,
    grid_division: int = 4,
) -> None:
    """Snap note boundaries to the 16th(ish) grid, in place.

    Reference ``encode.py:900-936``.  Continuation notes (velocity == -1)
    are clamped to the bar end; notes that collapse to zero length at grid
    slot 0 are marked deleted (``start = end = -1``).
    """
    divided_beats: List[float] = []
    for i in range(len(beat_times) - 1):
        for j in range(grid_division):
            divided_beats.append(
                (beat_times[i + 1] - beat_times[i]) / grid_division * j + beat_times[i]
            )
    divided_beats.append(beat_times[-1])
    grid = np.asarray(divided_beats)

    for note in notes:
        start_grid = int(np.argmin(np.abs(note.start - grid)))

        if note.velocity == -1 and note.end > grid[-1]:
            note.end = grid[-1]

        if note.end < grid[-1] + minimum_difference:
            end_grid = int(np.argmin(np.abs(note.end - grid)))
            if start_grid == end_grid:
                if end_grid != len(grid) - 1:
                    end_grid += 1
                elif start_grid != 0:
                    start_grid -= 1
                else:
                    note.start = -1.0
                    note.end = -1.0
                    continue
            note.start = float(grid[start_grid])
            note.end = float(grid[end_grid])
        else:
            note.start = float(grid[start_grid])


# ---------------------------------------------------------------------------
# Bar -> events (chord grouping with continue / sep)
# ---------------------------------------------------------------------------


def _flush_chord_group(
    chord_list: List[Note],
    next_bar_time: float,
    table: DurationTable,
    continue_note_dict: Dict[int, Note],
    out: List[str],
) -> None:
    """Emit events for one chord group (same onset, ~same release).

    Order: continuation notes first (prefixed once with ``continue``), then
    newly struck notes; if both kinds are present they are separated by
    ``sep`` carrying the continuation group's duration (reference
    ``encode.py:991-1051``).  Adjacent duplicate pitches are removed,
    keeping the later (newly struck) one.  Parity note: ADJACENT-only by
    design — a pitch in both the continuation and new-strike groups
    survives twice when other pitches interleave (e.g. continues [60,64]
    + strikes [60,62]), exactly as the reference's ``remove_pos`` scan
    behaves (``encode.py:1007-1012``); token-exact parity wins over the
    cleaner global dedup.
    """
    continues = sorted((n for n in chord_list if n.velocity == -1), key=lambda n: n.pitch)
    others = sorted((n for n in chord_list if n.velocity != -1), key=lambda n: n.pitch)
    merged = continues + others
    dedup: List[Note] = []
    for pos, note in enumerate(merged):
        if pos + 1 < len(merged) and note.pitch == merged[pos + 1].pitch:
            continue
        dedup.append(note)

    def emit(note: Note) -> List[str]:
        if note.end > next_bar_time:
            continue_note_dict[note.pitch] = Note(
                velocity=-1, pitch=note.pitch, start=next_bar_time, end=note.end
            )
            dur = next_bar_time - note.start
        else:
            dur = note.end - note.start
        return table.time_to_names(dur)

    cont_group = [n for n in dedup if n.velocity == -1]
    new_group = [n for n in dedup if n.velocity != -1]

    duration_event: List[str] = []
    if cont_group:
        out.append("continue")
        for n in cont_group:
            out.append(f"p_{n.pitch}")
            duration_event = emit(n)
        if new_group:
            out.extend(duration_event)
            out.append("sep")
    if new_group:
        for n in new_group:
            out.append(f"p_{n.pitch}")
            duration_event = emit(n)
    out.extend(duration_event)


_USE_NATIVE_TOKENIZER = True
_native_tokenize = None
_native_track_tokenize = None


def set_native_tokenizer(enabled: bool) -> None:
    """Toggle the C++ tokenizer core (``native/smer_tokenizer.cpp``)."""
    global _USE_NATIVE_TOKENIZER
    _USE_NATIVE_TOKENIZER = enabled


def tokenize_bar(
    notes: List[Note],
    bar_time: float,
    next_bar_time: float,
    beat_times: Sequence[float],
    table: DurationTable,
    minimum_difference: float,
    grid_division: int = 4,
) -> Tuple[List[str], Dict[int, Note]]:
    """Per-bar tokenization; dispatches to the native core when built."""
    if _USE_NATIVE_TOKENIZER:
        global _native_tokenize
        if _native_tokenize is None:
            from ..native.tokenizer import bar_notes_to_event_native

            _native_tokenize = bar_notes_to_event_native
        result = _native_tokenize(
            notes, bar_time, next_bar_time, beat_times, table,
            minimum_difference, grid_division=grid_division,
        )
        if result is not None:
            return result
    return bar_notes_to_event(
        notes, bar_time, next_bar_time, beat_times, table,
        minimum_difference, grid_division=grid_division,
    )


def bar_notes_to_event(
    notes: List[Note],
    bar_time: float,
    next_bar_time: float,
    beat_times: Sequence[float],
    table: DurationTable,
    minimum_difference: float,
    grid_division: int = 4,
    is_grid: bool = True,
) -> Tuple[List[str], Dict[int, Note]]:
    """Tokenize one bar of one track (reference ``encode.py:957-1141``)."""
    out: List[str] = []
    continue_note_dict: Dict[int, Note] = {}

    if notes:
        if is_grid:
            grid_notes(beat_times, notes, minimum_difference, grid_division=grid_division)
            notes = [n for n in notes if n.start >= 0]
            notes.sort(key=lambda n: (n.start, n.end, n.pitch))
        if notes:
            rest_to_start = table.time_to_names(notes[0].start - bar_time)
        else:
            rest_to_start = table.time_to_names(next_bar_time - bar_time)
    else:
        rest_to_start = table.time_to_names(next_bar_time - bar_time)

    if rest_to_start:
        out.append("rest")
        out.extend(rest_to_start)

    chord_list: List[Note] = []
    for note in notes:
        if not chord_list:
            chord_list.append(note)
            continue
        last = chord_list[-1]
        same_onset = abs(note.start - last.start) < minimum_difference
        if (
            note.end > next_bar_time
            and same_onset
            and abs(next_bar_time - last.end) < minimum_difference
        ):
            chord_list.append(note)
        elif same_onset and abs(note.end - last.end) < minimum_difference:
            chord_list.append(note)
        else:
            _flush_chord_group(chord_list, next_bar_time, table, continue_note_dict, out)
            if note.start >= last.end:
                rest_parts = table.time_to_names(note.start - last.end)
                if rest_parts:
                    out.append("rest")
                    out.extend(rest_parts)
            else:
                out.append("sep")
                out.extend(table.time_to_names(note.start - last.start))
            chord_list = [note]

    if chord_list:
        _flush_chord_group(chord_list, next_bar_time, table, continue_note_dict, out)
        last = chord_list[-1]
        if last.end < next_bar_time:
            rest_parts = table.time_to_names(next_bar_time - last.end)
            if rest_parts:
                out.append("rest")
                out.extend(rest_parts)

    return out, continue_note_dict


# ---------------------------------------------------------------------------
# MIDI -> events front ends
# ---------------------------------------------------------------------------


def _prepare_beats(score: MidiScore) -> Tuple[np.ndarray, np.ndarray]:
    beats = np.unique(score.get_beats())
    down_beats = np.unique(score.get_downbeats())
    tempo = score.get_tempo_changes()[1][0]
    sig = score.time_signature_changes[0]
    quarter = 60.0 / tempo
    beat_len = quarter * 1.5 if sig.denominator == 8 else quarter
    if len(beats) < 2:
        beats = np.append(beats, beats[-1] + beat_len)
    if len(down_beats) == 1:
        bar_time = 4 * 60.0 / tempo * sig.numerator / sig.denominator
        down_beats = np.array([down_beats[0], down_beats[0] + bar_time])
    if beats[-1] >= down_beats[-1]:
        down_beats = np.append(down_beats, down_beats[-1] + down_beats[-1] - down_beats[-2])
    # extend beats up to the appended downbeat.  The step must TERMINATE
    # even when the last beat interval does not evenly divide the gap
    # (e.g. a tempo change just before the end): overshooting steps snap
    # to the downbeat instead of looping forever past it.
    while beats[-1] < down_beats[-1] - 1e-4:
        step = beats[-1] - beats[-2]
        if step <= 1e-6:
            step = beat_len
        nxt = beats[-1] + step
        if nxt > down_beats[-1] - 1e-4:
            nxt = down_beats[-1]
        beats = np.append(beats, nxt)
    return beats, down_beats


def _validate_signatures(score: MidiScore, normalize_1_4: bool = False) -> Optional[List[Tuple[int, int]]]:
    changes = score.time_signature_changes
    if not changes or changes[0].time != 0:
        return None
    if len(changes) > 1:
        return None
    sigs = []
    for s in changes:
        if normalize_1_4 and s.numerator == 1 and s.denominator == 4:
            s.numerator = 4
        sigs.append((s.numerator, s.denominator))
    for sig in sigs:
        if sig not in SUPPORTED_SIGNATURES:
            return None
    return sigs


def midi_to_events_window(
    score: MidiScore, track_names: Sequence[str]
) -> Optional[Tuple[List[str], MidiScore, float]]:
    """Serving tokenizer: first 16 bars, padded to 16 with rest bars.

    ``track_names`` assigns the emitted ``track_i`` label per instrument
    (reference ``encode.py:1144-1314``).
    """
    sigs = _validate_signatures(score)
    if sigs is None:
        return None
    numerator, denominator = sigs[0]
    tempo = float(score.get_tempo_changes()[1][0])
    beats, down_beats = _prepare_beats(score)
    beat_in_bar = int(4 * numerator / denominator)
    down_beats = down_beats[:16]
    dbi = [int(np.argmin(np.abs(beats - db))) for db in down_beats]

    grid_division = 6 if (numerator, denominator) == (6, 8) else 4

    track_num = len(score.instruments)
    for inst in score.instruments:
        inst.notes.sort(key=lambda n: n.start)

    events: List[str] = [f"{numerator}/{denominator}", f"{tempo}"]
    for inst in score.instruments[:track_num]:
        events.append(f"i_{inst.program}")

    continue_dicts: List[Dict[int, Note]] = [{} for _ in range(track_num)]
    table = None
    beat_duration = beats[1] - beats[0] if len(beats) > 1 else 60.0 / tempo

    bar = -1
    for bar, bar_time in enumerate(down_beats):
        events.append("bar")
        beat_position = dbi[bar]
        if beat_position + 1 < len(beats):
            beat_duration = beats[beat_position + 1] - beats[beat_position]
        table = get_duration_table(beat_duration, (numerator, denominator))
        md = table.minimum_difference

        if bar + 1 < len(down_beats):
            next_bar_time = down_beats[bar + 1]
        else:
            next_bar_time = down_beats[bar] + table.bar_duration

        for track in range(track_num):
            events.append(track_names[track])
            continue_note_dict = continue_dicts[track]
            bar_notes = [
                Note(n.velocity, n.pitch, n.start, n.end)
                for n in score.instruments[track].notes
                if bar_time - md <= n.start < next_bar_time - md
            ]
            bar_notes = [
                n for n in bar_notes if TRACK_0_RANGE[0] <= n.pitch <= TRACK_0_RANGE[1]
            ]
            if not bar_notes:
                events.append("rest")
                events.extend(table.time_to_names(table.bar_duration))
                continue
            if bar != 15 and bar + 1 < len(dbi):
                beat_in_this_bar = beats[dbi[bar] : dbi[bar + 1] + 1]
            else:
                # bar 15 (reference encode.py:1281-1282) — or the final
                # bar of a short (< 16-bar) song, where dbi[bar + 1] does
                # not exist: take one bar's worth of beats instead
                beat_in_this_bar = beats[dbi[bar] : dbi[bar] + beat_in_bar + 1]
            if continue_note_dict:
                bar_notes = list(continue_note_dict.values()) + bar_notes
            bar_events, continue_note_dict = tokenize_bar(
                bar_notes,
                bar_time,
                next_bar_time,
                beat_in_this_bar,
                table,
                md,
                grid_division=grid_division,
            )
            events.extend(bar_events)
            continue_dicts[track] = continue_note_dict

    # pad to 16 bars with `unk` tension slot + full-bar rests
    bar += 1
    if table is None:
        table = get_duration_table(beat_duration, (numerator, denominator))
    for _ in range(16 - bar):
        events.append("bar")
        events.append("unk")
        for track in range(track_num):
            events.append(f"track_{track}")
            events.append("rest")
            events.extend(table.time_to_names(table.bar_duration))

    return events, score, tempo


ROLE_TO_TRACK = {
    "melody": "track_0",
    "bass": "track_1",
    "accompaniment": "track_2",
    "chord": "track_2",
}


def _tokenize_tracks_native(
    score: MidiScore,
    track_num: int,
    down_beats,
    beats,
    dbi,
    bar_tables,
    grid_division: int,
):
    """All tracks through the one-call-per-track native core; None -> caller
    falls back to the per-bar loop."""
    global _native_track_tokenize
    if _native_track_tokenize is None:
        from ..native.tokenizer import track_notes_to_events_native

        _native_track_tokenize = track_notes_to_events_native
    out = []
    for t in range(track_num):
        notes = [
            n
            for n in score.instruments[t].notes
            if TRACK_0_RANGE[0] <= n.pitch <= TRACK_0_RANGE[1]
        ]
        res = _native_track_tokenize(
            notes, down_beats, beats, dbi, bar_tables,
            grid_division=grid_division,
        )
        if res is None:
            return None
        out.append(res)
    return out


def midi_to_events(
    score: MidiScore, roles: Optional[Sequence[str]] = None, max_track: int = 3
) -> Optional[Tuple[List[str], MidiScore]]:
    """Corpus tokenizer (reference ``preprocessing.py:519-715``).

    ``roles`` maps instrument position to a named role
    (melody/bass/accompaniment/chord); ``None`` labels tracks positionally.
    Rejects multi-signature or unsupported-signature files.
    """
    if not score.instruments:
        return None
    sigs = _validate_signatures(score, normalize_1_4=True)
    if sigs is None:
        return None
    numerator, denominator = sigs[0]
    tempo = float(score.get_tempo_changes()[1][0])

    beats = np.unique(score.get_beats())
    down_beats = np.unique(score.get_downbeats())
    if len(down_beats) < 2:
        return None
    if beats[-1] > down_beats[-1]:
        down_beats = np.append(down_beats, down_beats[-1] + down_beats[-1] - down_beats[-2])
    if not np.isclose(down_beats[-1] - beats[-1], 0):
        beats = np.append(beats, beats[-1] + beats[-1] - beats[-2])
    dbi = [int(np.argmin(np.abs(beats - db))) for db in down_beats]

    grid_division = 6 if (numerator, denominator) == (6, 8) else 4

    track_num = min(len(score.instruments), max_track)
    for num in range(track_num):
        score.instruments[num].notes.sort(key=lambda n: n.start)

    if roles is not None:
        labels = [ROLE_TO_TRACK.get(r) for r in roles[:track_num]]
        if any(lb is None for lb in labels):
            return None
    else:
        labels = [f"track_{i}" for i in range(track_num)]

    events: List[str] = [f"{numerator}/{denominator}", f"{tempo}"]
    for inst in score.instruments[:track_num]:
        events.append(f"i_{inst.program}")

    # per-bar duration tables (memoized: usually one distinct table)
    n_bars = len(down_beats) - 1
    bar_tables = [
        get_duration_table(
            beats[dbi[bar] + 1] - beats[dbi[bar]], (numerator, denominator)
        )
        for bar in range(n_bars)
    ]

    if _USE_NATIVE_TOKENIZER:
        per_track = _tokenize_tracks_native(
            score, track_num, down_beats, beats, dbi, bar_tables, grid_division
        )
        if per_track is not None:
            for bar in range(n_bars):
                events.append("bar")
                for track in range(track_num):
                    events.append(labels[track])
                    events.extend(per_track[track][bar])
            return events, score

    continue_dicts: List[Dict[int, Note]] = [{} for _ in range(track_num)]

    # notes are sorted by start, so each bar's notes are a contiguous
    # slice — binary-search the window instead of rescanning every note
    # of the track per bar (O(bars x notes) -> O(bars log notes))
    track_starts = [
        np.fromiter(
            (n.start for n in score.instruments[t].notes),
            np.float64,
            len(score.instruments[t].notes),
        )
        for t in range(track_num)
    ]

    for bar, bar_time in enumerate(down_beats[:-1]):
        events.append("bar")
        beat_position = dbi[bar]
        beat_duration = beats[beat_position + 1] - beats[beat_position]
        table = get_duration_table(beat_duration, (numerator, denominator))
        md = table.minimum_difference
        next_bar_time = down_beats[bar + 1]

        for track in range(track_num):
            events.append(labels[track])
            continue_note_dict = continue_dicts[track]
            starts = track_starts[track]
            lo = int(np.searchsorted(starts, bar_time - md, "left"))
            hi = int(np.searchsorted(starts, next_bar_time - md, "left"))
            bar_notes = [
                Note(n.velocity, n.pitch, n.start, n.end)
                for n in score.instruments[track].notes[lo:hi]
                if TRACK_0_RANGE[0] <= n.pitch <= TRACK_0_RANGE[1]
            ]
            beat_in_this_bar = beats[dbi[bar] : dbi[bar + 1] + 1]
            if continue_note_dict:
                bar_notes = list(continue_note_dict.values()) + bar_notes
            bar_events, continue_note_dict = tokenize_bar(
                bar_notes,
                bar_time,
                next_bar_time,
                beat_in_this_bar,
                table,
                md,
                grid_division=grid_division,
            )
            events.extend(bar_events)
            continue_dicts[track] = continue_note_dict

    return events, score


# ---------------------------------------------------------------------------
# Events -> MIDI (the decode VM)
# ---------------------------------------------------------------------------


def filter_empty_bars(events: Sequence[str]) -> List[str]:
    """Strip leading bars that contain no notes (reference
    ``preprocessing.py:721-744``; that version also drops the first filled
    bar's ``bar`` token — here the filled bar is kept intact)."""
    events = list(events)
    bar_poses = [i for i, e in enumerate(events) if e == "bar"]
    if not bar_poses:
        return events
    first_filled = None
    for bi, lo in enumerate(bar_poses):
        hi = bar_poses[bi + 1] if bi + 1 < len(bar_poses) else len(events)
        if any(e.startswith("p_") and e[2:].isdigit() for e in events[lo:hi]):
            first_filled = bi
            break
    if first_filled is None or first_filled == 0:
        return events
    return events[: bar_poses[0]] + events[bar_poses[first_filled] :]


def bar_events_to_midi(
    bar_tokens: Sequence[str],
    headers: Sequence[str],
    velocities: Sequence[int] = CORPUS_VELOCITIES,
) -> Optional[MidiScore]:
    """Headers + bar-level tokens -> MIDI (reference
    ``preprocessing.py:755-958`` ``bar_event_2_midi``, used by the
    evaluation harness to re-measure regenerated bars)."""
    return events_to_midi(list(headers) + list(bar_tokens), velocities=velocities)


def remove_empty_tracks(score: MidiScore, min_occupation: float = 0.3) -> Optional[MidiScore]:
    """Drop instruments occupying < 30% of 16th slots (reference
    ``preprocessing.py:92-113`` / ``encode.py:537-556``); None for songs
    shorter than 20 beats."""
    beats = score.get_beats()
    if len(beats) < 20:
        return None
    fs = 4 / (beats[1] - beats[0])
    keep = []
    for inst in score.instruments:
        roll = inst.get_piano_roll(fs=fs)
        if roll.shape[1] == 0:
            rate = 0.0
        else:
            rate = np.count_nonzero(np.any(roll, 0)) / roll.shape[1]
        if rate >= min_occupation:
            keep.append(inst)
    score.instruments = keep
    return score


def remove_control_event(events: Sequence[str], control_tokens: Sequence[str]) -> List[str]:
    control = set(control_tokens)
    return [e for e in events if e not in control]


def decode_tempo_token(token: str) -> float:
    """``t_k`` -> representative BPM (bin midpoint; last bin is its edge)."""
    category = int(token[2])
    if category == len(TEMPO_BINS) - 1:
        return float(TEMPO_BINS[category])
    return float(TEMPO_BINS[category] + TEMPO_BINS[category + 1]) / 2


def events_to_midi(
    events: Sequence[str],
    tempo: Optional[float] = None,
    velocities: Sequence[int] = SERVING_VELOCITIES,
) -> Optional[MidiScore]:
    """Decode an event stream into a :class:`MidiScore`.

    Mirrors reference ``encode.py:297-534``: fixed-width bars; per track the
    cursor resets to the bar start; ``rest`` groups advance, ``sep`` groups
    rewind to the previous group's start then advance, ``continue`` groups
    extend the note(s) of the previous bar that end at the cursor.
    """
    events = remove_control_event(list(events), CONTROL_TOKENS)
    if len(events) < 3:
        return None
    if tempo is None:
        if events[1].startswith("t_"):
            tempo = decode_tempo_token(events[1])
        else:
            tempo = float(events[1])

    try:
        numerator, denominator = (int(x) for x in events[0].split("/"))
    except (ValueError, IndexError):
        return None

    score = MidiScore(initial_tempo=tempo)
    score.time_signature_changes = [TimeSignature(numerator, denominator, 0.0)]

    programs = [e for e in events if e[:2] == "i_" and e[2:].isdigit()]
    track_names = sorted(
        {e for e in events if e[:6] == "track_" and e[6:].isdigit()}
    )
    track_name_to_index = {name: i for i, name in enumerate(track_names)}

    bar_positions = [i for i, e in enumerate(events) if e == "bar"]
    if not bar_positions or not programs:
        return None
    bar_start_pos = bar_positions[0]

    for index, prog in enumerate(programs):
        inst = Instrument(program=int(prog.split("_")[-1]))
        if index < len(track_names) and track_names[index] == "track_4":
            inst.is_drum = True
        score.instruments.append(inst)

    beat = 60.0 / tempo
    if denominator == 8:
        beat *= 1.5
    table = get_duration_table(beat, (numerator, denominator))
    bar_duration = table.bar_duration

    n_bars = len(bar_positions)
    score.lyrics = [Lyric("end", n_bars * bar_duration)]

    curr_time = 0.0
    previous_duration = 0.0
    bar_start_time = 0.0
    in_duration_event = False
    is_sep = False
    is_continue = False
    pitch_list: List[int] = []
    duration_list: List[str] = []
    bar_num = 0
    track = 0

    def flush() -> None:
        nonlocal curr_time, previous_duration
        duration = table.total_duration(duration_list)
        start = curr_time - previous_duration if is_sep else curr_time
        for pitch in pitch_list:
            if is_continue:
                for note in reversed(score.instruments[track].notes):
                    if abs(note.end - start) < 1e-6 and note.pitch == pitch:
                        note.end += duration
                        break
            else:
                vel = velocities[min(track, len(velocities) - 1)]
                score.instruments[track].notes.append(
                    Note(velocity=vel, pitch=pitch, start=start, end=start + duration)
                )
        curr_time = start + duration
        previous_duration = duration

    for event in events[bar_start_pos:]:
        if event in table.name_to_time:
            duration_list.append(event)
            in_duration_event = True
            continue

        if in_duration_event:
            flush()
            pitch_list = []
            duration_list = []
            in_duration_event = False
            is_sep = False
            is_continue = False

        pitch = _PITCH_LOOKUP.get(event)
        if pitch is not None:
            pitch_list.append(pitch)
            continue
        if event == "sep":
            is_sep = True
            continue
        if event == "continue":
            if bar_num >= 2:
                is_continue = True
            continue
        if event == "bar":
            bar_start_time = bar_num * bar_duration
            bar_num += 1
            continue
        if event in track_name_to_index:
            curr_time = bar_start_time
            previous_duration = 0.0
            track = track_name_to_index[event]
            continue
        # headers (time sig / tempo / programs) and unknown tokens: ignore

    if in_duration_event:
        flush()

    return score

"""Control-token annotation: the serving-side ``encode_midi`` pipeline.

Reimplements reference ``encode.py:559-804`` (control insertion) and
``encode.py:1376-1505`` (tokenize -> round-trip -> tension/key -> controls
orchestration) on this framework's codec + feature engine.  Data flows
in-memory end to end (the reference routes the drumless MIDI through a
``no_drum.mid`` temp file).

Host copy of ``smer_music_generation_tpu/codec/annotate.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features.controls import note_density, occupation_polyphony_rate
from ..features.keyvote import vote_key
from ..features.tension import score_tension
from ..vocab import CONTROL_BINS, KEY_TO_TOKEN, TEMPO_BINS, to_category
from .midi import MidiScore
from .smer import events_to_midi, midi_to_events_window
from .structure import programs_of, split_track_events, track_names_of

GM_INSTRUMENT_NAMES = [
    # General MIDI program names (0-127), used for the UI controls dict
    "Acoustic Grand Piano", "Bright Acoustic Piano", "Electric Grand Piano",
    "Honky-tonk Piano", "Electric Piano 1", "Electric Piano 2", "Harpsichord",
    "Clavinet", "Celesta", "Glockenspiel", "Music Box", "Vibraphone",
    "Marimba", "Xylophone", "Tubular Bells", "Dulcimer", "Drawbar Organ",
    "Percussive Organ", "Rock Organ", "Church Organ", "Reed Organ",
    "Accordion", "Harmonica", "Tango Accordion", "Acoustic Guitar (nylon)",
    "Acoustic Guitar (steel)", "Electric Guitar (jazz)", "Electric Guitar (clean)",
    "Electric Guitar (muted)", "Overdriven Guitar", "Distortion Guitar",
    "Guitar Harmonics", "Acoustic Bass", "Electric Bass (finger)",
    "Electric Bass (pick)", "Fretless Bass", "Slap Bass 1", "Slap Bass 2",
    "Synth Bass 1", "Synth Bass 2", "Violin", "Viola", "Cello", "Contrabass",
    "Tremolo Strings", "Pizzicato Strings", "Orchestral Harp", "Timpani",
    "String Ensemble 1", "String Ensemble 2", "Synth Strings 1",
    "Synth Strings 2", "Choir Aahs", "Voice Oohs", "Synth Choir",
    "Orchestra Hit", "Trumpet", "Trombone", "Tuba", "Muted Trumpet",
    "French Horn", "Brass Section", "Synth Brass 1", "Synth Brass 2",
    "Soprano Sax", "Alto Sax", "Tenor Sax", "Baritone Sax", "Oboe",
    "English Horn", "Bassoon", "Clarinet", "Piccolo", "Flute", "Recorder",
    "Pan Flute", "Blown Bottle", "Shakuhachi", "Whistle", "Ocarina",
    "Lead 1 (square)", "Lead 2 (sawtooth)", "Lead 3 (calliope)",
    "Lead 4 (chiff)", "Lead 5 (charang)", "Lead 6 (voice)", "Lead 7 (fifths)",
    "Lead 8 (bass + lead)", "Pad 1 (new age)", "Pad 2 (warm)",
    "Pad 3 (polysynth)", "Pad 4 (choir)", "Pad 5 (bowed)", "Pad 6 (metallic)",
    "Pad 7 (halo)", "Pad 8 (sweep)", "FX 1 (rain)", "FX 2 (soundtrack)",
    "FX 3 (crystal)", "FX 4 (atmosphere)", "FX 5 (brightness)",
    "FX 6 (goblins)", "FX 7 (echoes)", "FX 8 (sci-fi)", "Sitar", "Banjo",
    "Shamisen", "Koto", "Kalimba", "Bag pipe", "Fiddle", "Shanai",
    "Tinkle Bell", "Agogo", "Steel Drums", "Woodblock", "Taiko Drum",
    "Melodic Tom", "Synth Drum", "Reverse Cymbal", "Guitar Fret Noise",
    "Breath Noise", "Seashore", "Bird Tweet", "Telephone Ring", "Helicopter",
    "Applause", "Gunshot",
]


def program_to_instrument_name(program: int) -> str:
    return GM_INSTRUMENT_NAMES[int(program) % 128]


def tempo_to_token(tempo: float) -> str:
    category = int(np.where((float(tempo) - TEMPO_BINS) >= 0)[0][-1])
    return f"t_{category}"


def add_control_events(
    file_events: Sequence[str],
    header_events: Sequence[str],
    key: str,
    tensiles: Optional[Sequence[int]],
    score: MidiScore,
    remove_continue: bool = True,
    add_bar: bool = True,
) -> Optional[Tuple[List[str], Dict]]:
    """Insert key/track/bar control tokens and build the UI controls dict.

    Reference ``remove_continue_add_control_event`` (``encode.py:559-804``,
    corpus twin ``create_dataset.py:273-504``): optionally strips first-bar
    ``continue``, bins the tempo, inserts ``k_*`` at slot 2, song-level
    ``d/o/y`` triplets after it, ``s_*`` after each ``bar`` and (with
    ``add_bar``) per-bar-track ``d o y`` after each ``track_i``.
    """
    file_events = np.array(file_events)
    num_of_tracks = len(header_events) - 2

    bar_pos = np.where(file_events == "bar")[0]
    if remove_continue and len(bar_pos) > 1:
        events: List[str] = [
            e for idx, e in enumerate(file_events)
            if not (e == "continue" and idx < bar_pos[1])
        ]
    else:
        events = list(file_events)
    events = list(header_events) + events

    all_controls: Dict = {
        "time_signature": events[0],
        "tempo": events[1][-1],
        "key": key,
    }

    if "_" not in events[1]:
        events[1] = tempo_to_token(float(events[1]))

    bar_pos = [i for i, e in enumerate(events) if e == "bar"]
    bar_beats = int(str(header_events[0])[0])
    if bar_beats != 6:
        bar_sixteenths = bar_beats * 4
    else:
        bar_sixteenths = bar_beats // 2 * 4
    total_sixteenths = bar_sixteenths * len(bar_pos)

    track_names = track_names_of(events)
    track_events = split_track_events(events)

    total_densities, bar_densities = note_density(
        track_events, bar_sixteenths, total_sixteenths
    )
    total_density_cat = to_category(total_densities, CONTROL_BINS)
    for name in bar_densities:
        bar_densities[name] = to_category(bar_densities[name], CONTROL_BINS)

    beat_time = score.get_beats()
    if int(header_events[0][0]) != 6:
        sixteenth_time = (beat_time[1] - beat_time[0]) / 4
    else:
        sixteenth_time = (beat_time[1] - beat_time[0]) / 6

    occupation, polyphony, bar_occupation, bar_polyphony = occupation_polyphony_rate(
        score, bar_sixteenths, sixteenth_time, len(bar_pos)
    )

    if (
        len(next(iter(bar_densities.values()))) != len(bar_pos)
        or len(bar_occupation[0]) != len(bar_pos)
        or len(bar_polyphony[0]) != len(bar_pos)
    ):
        return None

    total_occupation_cat = to_category(occupation, CONTROL_BINS)
    total_polyphony_cat = to_category(polyphony, CONTROL_BINS)
    if not (
        len(total_density_cat) == len(track_names)
        and len(total_occupation_cat) == len(track_names)
        and len(total_polyphony_cat) == len(track_names)
    ):
        return None

    density_tok = [f"d_{c}" for c in total_density_cat]
    occupation_tok = [f"o_{c}" for c in total_occupation_cat]
    polyphony_tok = [f"y_{c}" for c in total_polyphony_cat]
    track_control_tokens = density_tok + occupation_tok + polyphony_tok

    events.insert(2, KEY_TO_TOKEN[key])
    for token in track_control_tokens[::-1]:
        events.insert(3, token)

    if tensiles is not None:
        tension_positions = [i for i, e in enumerate(events) if e == track_names[0]]
        assert len(tension_positions) == len(bar_pos)
        total_insert = 0
        for i, pos in enumerate(tension_positions):
            events.insert(pos + total_insert, f"s_{tensiles[i]}")
            total_insert += 1

    all_controls["bar_density"] = {}
    all_controls["bar_occupation"] = {}
    all_controls["bar_polyphony"] = {}
    for name in track_names:
        all_controls["bar_density"][name] = []
        all_controls["bar_occupation"][name] = []
        all_controls["bar_polyphony"][name] = []
        all_controls[name] = {
            "instrument": 10, "density": 10, "polyphony": 10, "occupation": 10,
        }

    if not add_bar:
        all_controls["track_nums"] = num_of_tracks
        all_controls["tensile"] = list(tensiles) if tensiles is not None else None
        all_controls["bar_nums"] = len(bar_pos)
        return events, all_controls

    for track_idx, name in enumerate(track_names):
        bar_occ_cat = to_category(bar_occupation[track_idx], CONTROL_BINS)
        bar_poly_cat = to_category(bar_polyphony[track_idx], CONTROL_BINS)
        bar_track_pos = [i + 1 for i, e in enumerate(events) if e == name]
        total_insert = 0
        for i, pos in enumerate(bar_track_pos):
            if i >= len(bar_densities[name]):
                events.insert(pos + total_insert, "d_0")
                all_controls["bar_density"][name].append(0)
            else:
                events.insert(pos + total_insert, f"d_{bar_densities[name][i]}")
                all_controls["bar_density"][name].append(bar_densities[name][i])
            total_insert += 1
            if i >= len(bar_occ_cat):
                events.insert(pos + total_insert, "o_0")
                all_controls["bar_occupation"][name].append(0)
            else:
                events.insert(pos + total_insert, f"o_{bar_occ_cat[i]}")
                all_controls["bar_occupation"][name].append(bar_occ_cat[i])
            total_insert += 1
            if i >= len(bar_poly_cat):
                events.insert(pos + total_insert, "y_0")
                all_controls["bar_polyphony"][name].append(0)
            else:
                events.insert(pos + total_insert, f"y_{bar_poly_cat[i]}")
                all_controls["bar_polyphony"][name].append(bar_poly_cat[i])
            total_insert += 1

    all_controls["track_nums"] = num_of_tracks
    for track_idx, prog_tok in enumerate(header_events[2:]):
        name = track_names[track_idx]
        all_controls[name]["instrument"] = program_to_instrument_name(int(prog_tok[2:]))
        all_controls[name]["density"] = int(density_tok[track_idx][-1])
        all_controls[name]["polyphony"] = int(polyphony_tok[track_idx][-1])
        all_controls[name]["occupation"] = int(occupation_tok[track_idx][-1])

    all_controls["tensile"] = list(tensiles) if tensiles is not None else None
    all_controls["bar_nums"] = len(tensiles) if tensiles is not None else len(bar_pos)

    return events, all_controls


def file_info(score: MidiScore) -> Optional[Dict]:
    """Song-level summary for the serving UI: voted key, tempo, counts
    (reference ``encode.py:817-897``)."""
    from ..features.keyvote import vote_key
    from ..features.tension import score_tension

    track_num = len(score.instruments)
    bar_num = len(np.unique(score.get_downbeats()))
    tempo = float(score.get_tempo_changes()[1][0])
    res = score_tension(score)
    spiral_key = res[2] if res else None
    drumless = res[3] if res else score
    voted = vote_key(spiral_key, drumless)
    if voted is None:
        return None
    return {
        "key": voted[0],
        "tempo": tempo,
        "track_num": track_num,
        "bar_num": int(bar_num),
    }


def encode_midi(
    score: MidiScore,
    controls: Optional[Dict] = None,
    infill: bool = False,
    track_names: Sequence[str] = (),
) -> Optional[Tuple[List[str], Dict]]:
    """Full serving-side encode (reference ``encode.py:1376-1505``).

    Tokenize a 16-bar window, canonicalize through the event VM, compute
    tension + voted key, then insert control tokens.
    """
    result = midi_to_events_window(score, list(track_names))
    if result is None:
        return None
    events, score, tempo = result
    canonical = events_to_midi(events, tempo)
    if canonical is None:
        return None

    file_events = np.array(events)
    key = controls.get("key") if controls else None

    if key and key != "Not Set":
        if not infill:
            res = score_tension(canonical, key_names=[key])
            if res:
                tensiles, diameters, _, _ = res
            else:
                # the reference falls through with tensiles='' and crashes
                # on bar_pos[0] of an emptied array (encode.py:1399,1503);
                # a degenerate window (e.g. all notes filtered) gets a
                # clean None here instead
                return None
        else:
            tensiles = controls["tensile"]
    else:
        res = score_tension(canonical, key_names=None)
        if not res:
            return None
        tensiles, diameters, first_key, drumless = res
        voted = vote_key(first_key, drumless)
        if voted is None:
            return None
        key = voted[0]

    track_programs = programs_of(file_events.tolist())
    num_of_tracks = len(track_programs)
    if num_of_tracks < 1:
        return None

    file_events[1] = tempo_to_token(float(file_events[1]))
    header_events = file_events[: 2 + num_of_tracks]

    bar_pos = np.where(file_events == "bar")[0]
    total_bars = min(len(tensiles), len(bar_pos))
    if total_bars > 16:
        total_bars = 16
        file_events = file_events[: bar_pos[total_bars]]
        bar_pos = bar_pos[:total_bars]
    if total_bars < 16:
        if total_bars == 0:
            return None
        # truncate to exactly total_bars bars so the stream matches the
        # tensile list.  The reference keeps one extra bar
        # (bar_pos[total_bars + 1], encode.py:1496) and would then crash
        # inserting tensiles[total_bars]; data/build.py's corpus path
        # already truncates this way.
        file_events = file_events[: bar_pos[total_bars] if total_bars < len(bar_pos) else len(file_events)]
        bar_pos = bar_pos[:total_bars]

    return add_control_events(
        file_events[bar_pos[0] :].tolist(),
        header_events.tolist(),
        key,
        list(tensiles)[:total_bars],
        canonical,
    )

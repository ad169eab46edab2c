"""Tonal-tension features: key detection, tensile strain, cloud diameter.

Vectorized reimplementation of reference ``tension_calculation.py:242-721``
on top of :mod:`.spiral`.  The ``no_drum.mid`` temp-file side channel of the
reference (``tension_calculation.py:711`` -> ``encode.py:836``) is replaced
by returning the drumless score in-memory.

Host copy of ``smer_music_generation_tpu/features/tension.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..codec.midi import MidiScore
from . import spiral
from .spiral import (
    ALL_KEY_NAMES,
    ENHARMONIC_DICT,
    ENHARMONIC_REVERSE_DICT,
    PITCH_INDEX_TO_FLAT_NAMES,
    PITCH_INDEX_TO_PITCH_NAME,
    PITCH_INDEX_TO_SHARP_NAMES,
    PITCH_NAME_TO_PITCH_INDEX,
    VALID_MAJOR,
    VALID_MINOR,
    centroids_for_shift,
    diameters_for_shift,
    major_key_position,
    minor_key_position,
)


@dataclass
class NoteGrid:
    """Output of :func:`extract_notes` (reference returns a 7-tuple)."""

    score: MidiScore  # drumless copy
    piano_roll: np.ndarray  # (128, T) binary, T = #16th steps
    sixteenth_time: np.ndarray
    beat_time: np.ndarray
    down_beat_time: np.ndarray
    beat_indices: List[int]
    down_beat_indices: List[int]


def get_beat_time(score: MidiScore, beat_division: int = 4):
    """16th grid + beat/downbeat indices (reference ``get_beat_time``)."""
    beats = score.get_beats()
    divided: List[float] = []
    for i in range(len(beats) - 1):
        for j in range(beat_division):
            divided.append((beats[i + 1] - beats[i]) / beat_division * j + beats[i])
    divided.append(beats[-1])
    divided = np.unique(np.asarray(divided))

    beat_indices = [int(np.argwhere(divided == b)[0][0]) for b in beats]

    down_beats = score.get_downbeats()
    if divided[-1] > down_beats[-1]:
        if len(down_beats) >= 2:
            down_beats = np.append(
                down_beats, down_beats[-1] - down_beats[-2] + down_beats[-1]
            )
        else:
            # single-bar input: close the bar at the end of the grid
            down_beats = np.append(down_beats, divided[-1])
    down_beats = np.unique(down_beats)
    down_beat_indices = [int(np.argmin(np.abs(db - divided))) for db in down_beats]
    return divided, beats, down_beats, beat_indices, down_beat_indices


def extract_notes(score: MidiScore, track_num: int) -> Optional[NoteGrid]:
    """Drumless binary piano roll on the 16th grid (reference ``:688-721``)."""
    try:
        new = MidiScore(initial_tempo=score.initial_tempo)
        new.set_tempo_changes(list(zip(*score.get_tempo_changes())))
        new.time_signature_changes = list(score.time_signature_changes)
        new.lyrics = list(score.lyrics)
        for inst in score.instruments:
            if inst.is_drum:
                continue
            copy_inst = type(inst)(program=inst.program, is_drum=False, name=inst.name)
            copy_inst.notes = [type(n)(n.velocity, n.pitch, n.start, n.end) for n in inst.notes]
            # drop the reference's fake pitch-1 placeholder notes if present
            if copy_inst.notes and copy_inst.notes[0].pitch == 1:
                del copy_inst.notes[0]
            new.instruments.append(copy_inst)
        if track_num != 0:
            new.instruments = new.instruments[:track_num]
        if not new.instruments:
            return None
        sixteenth_time, beat_time, down_beat_time, beat_indices, down_beat_indices = get_beat_time(
            new, beat_division=4
        )
        piano_roll = (new.get_piano_roll(times=sixteenth_time) > 0).astype(int)
        return NoteGrid(
            new, piano_roll, sixteenth_time, beat_time, down_beat_time, beat_indices, down_beat_indices
        )
    except (ValueError, IndexError, KeyError, ZeroDivisionError):
        return None


# ---------------------------------------------------------------------------
# Key detection
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _key_geometry(name: str):
    """(canonical key name, reference position, centroid shift) for one key.

    Mirrors reference ``cal_key`` (``tension_calculation.py:242-311``): all
    major keys compare against the C-major position, all minors against the
    A-minor position, with the piece centroid shifted into that frame.
    """
    key, mode = name.split()
    valid = VALID_MINOR if mode == "minor" else VALID_MAJOR
    if key not in valid:
        if key in ENHARMONIC_DICT:
            key = ENHARMONIC_DICT[key]
        elif key in ENHARMONIC_REVERSE_DICT:
            key = ENHARMONIC_REVERSE_DICT[key]
    if key not in valid:
        return None
    key_index = PITCH_NAME_TO_PITCH_INDEX[key]
    if mode == "minor":
        key_pos = minor_key_position(3)
        key_index -= 3
    else:
        key_pos = major_key_position(0)
    shift_name = PITCH_INDEX_TO_PITCH_NAME[key_index]
    if shift_name in PITCH_INDEX_TO_SHARP_NAMES:
        shift = int(np.argwhere(PITCH_INDEX_TO_SHARP_NAMES == shift_name)[0][0])
    else:
        shift = int(np.argwhere(PITCH_INDEX_TO_FLAT_NAMES == shift_name)[0][0])
    return key_pos, shift


def cal_key(
    piano_roll: np.ndarray,
    key_names: Sequence[str],
    end_ratio: float = 1.0,
) -> Optional[Tuple[str, np.ndarray, int]]:
    """Pick the key whose frame minimizes ||piece centroid - key position||."""
    end = int(piano_roll.shape[1] * end_ratio)
    roll = piano_roll[:, :end]
    counts = spiral.class_counts(roll > 0).sum(axis=1)  # (12,) total activations
    total = counts.sum()
    if total == 0:
        return None

    best = None
    for name in key_names:
        geom = _key_geometry(name)
        if geom is None:
            return None
        key_pos, shift = geom
        ce = counts @ spiral.CLASS_POSITIONS[shift] / total
        distance = float(np.linalg.norm(ce - key_pos))
        if best is None or distance < best[0]:
            best = (distance, name, key_pos, shift)
    _, key_name, key_pos, shift = best
    return key_name, key_pos, shift


# ---------------------------------------------------------------------------
# Tension metrics
# ---------------------------------------------------------------------------


def merge_tension(
    metric: np.ndarray,
    beat_indices: Sequence[int],
    down_beat_indices: Sequence[int],
    window_size: int = -1,
) -> np.ndarray:
    """Aggregate a per-16th metric to bars (-1) or N-beat windows."""
    out = []
    if window_size == -1:
        for i in range(len(down_beat_indices) - 1):
            out.append(np.mean(metric[down_beat_indices[i] : down_beat_indices[i + 1]], axis=0))
    else:
        for i in range(0, len(beat_indices) - window_size, window_size):
            out.append(np.mean(metric[beat_indices[i] : beat_indices[i + window_size]], axis=0))
    return np.array(out)


def cal_tension(
    piano_roll: np.ndarray,
    beat_time: np.ndarray,
    beat_indices: Sequence[int],
    down_beat_time: np.ndarray,
    down_beat_indices: Sequence[int],
    window_size: int = -1,
    key_names: Optional[Sequence[str]] = None,
    end_ratio: float = 1.0,
) -> Optional[Tuple[np.ndarray, np.ndarray, str, str, int]]:
    """Per-bar tensile strain + cloud diameter (reference ``:370-518``).

    Returns ``(tensile, diameters, key_name, changed_key_name,
    key_change_beat)``.  Key-change detection is effectively disabled in the
    reference (gated on ``len(down_beat_time) > 9999999``) and therefore not
    attempted here; :func:`detect_key_change` is exposed separately.
    ``end_ratio`` limits key detection to the first fraction of the piece
    (reference ``cal_key`` ``:242``, CLI flag ``-r``).
    """
    if key_names is None:
        key_names = ALL_KEY_NAMES
    try:
        result = cal_key(piano_roll, key_names, end_ratio=end_ratio)
        if result is None:
            return None
        key_name, key_pos, shift = result

        centroids = centroids_for_shift(piano_roll, shift)  # (T, 3)
        merged = merge_tension(centroids, beat_indices, down_beat_indices, window_size)
        merged = np.asarray(merged)
        if merged.size == 0:
            return None
        silent = np.linalg.norm(merged, axis=-1) < 0.1

        key_diff = np.linalg.norm(merged - key_pos, axis=-1)
        key_diff[silent] = 0

        diam = diameters_for_shift(piano_roll, shift)
        diam = merge_tension(diam, beat_indices, down_beat_indices, window_size)
        diam[silent] = 0

        return key_diff, diam, key_name, "", -1
    except (ValueError, IndexError, KeyError, ZeroDivisionError):
        return None


def detect_key_change(key_diff: np.ndarray, diameter: np.ndarray, start_ratio: float = 0.5) -> int:
    """8-bar-window ratio test (reference ``:576-628``); -1 if none."""
    key_diff_ratios = []
    fill_one = False
    steps = 0
    for i in range(8, key_diff.shape[0] - 8):
        if fill_one and steps > 0:
            key_diff_ratios.append(1)
            steps -= 1
            if steps == 0:
                fill_one = False
            continue
        if np.any(key_diff[i - 4 : i]) and np.any(key_diff[i : i + 4]):
            previous = np.mean(key_diff[i - 4 : i])
            current = np.mean(key_diff[i : i + 4])
            key_diff_ratios.append(current / previous)
        else:
            fill_one = True
            steps = 4

    for i in range(int(len(key_diff_ratios) * start_ratio), len(key_diff_ratios) - 2):
        if np.mean(key_diff_ratios[i : i + 4]) > 2:
            return i + 12
    return -1


def key_after_change(
    piano_roll: np.ndarray, change_step: int
) -> Optional[Tuple[str, np.ndarray, int]]:
    """Re-detect the key from a change point on (reference
    ``get_key_index_change`` ``:521-536``, which rebuilds a PrettyMIDI of
    the notes after the change time; here the piano roll is sliced at the
    corresponding 16th step — notes sustained across the boundary keep
    their tail columns, a documented simplification)."""
    if change_step < 0 or change_step >= piano_roll.shape[1]:
        return None
    return cal_key(piano_roll[:, change_step:], ALL_KEY_NAMES)


def moving_average(tension: np.ndarray, window: int = 4) -> np.ndarray:
    zeros = np.zeros((window,), dtype=tension.dtype)
    padded = np.concatenate([tension, zeros], axis=0)
    return np.array(
        [np.mean(padded[i : i + window]) for i in range(padded.shape[0] - window + 1)]
    )


# ---------------------------------------------------------------------------
# High-level wrapper (reference encode.py:53-80)
# ---------------------------------------------------------------------------


def score_tension(
    score: MidiScore, key_names: Optional[Sequence[str]] = None
) -> Optional[Tuple[List[int], List[int], str, MidiScore]]:
    """(tensile categories, diameter categories, key, drumless score)."""
    from ..vocab import DIAMETER_BINS, TENSILE_BINS, to_category

    grid = extract_notes(score, len(score.instruments))
    if grid is None:
        return None
    result = cal_tension(
        grid.piano_roll,
        grid.beat_time,
        grid.beat_indices,
        grid.down_beat_time,
        grid.down_beat_indices,
        -1,
        key_names,
    )
    if result is None:
        return None
    tensiles, diameters, key_name, _, _ = result
    tensile_category = to_category(tensiles, TENSILE_BINS)
    diameter_category = to_category(diameters, DIAMETER_BINS)
    return tensile_category, diameter_category, key_name, grid.score

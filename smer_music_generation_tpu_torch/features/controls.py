"""Track/bar control metrics: note density, occupation, polyphony.

Reimplements the metric functions duplicated across the reference
(``encode.py:13-210``, ``create_dataset.py:71-221``, ``dataset.py:928-1006``)
in one home, vectorized where they loop.

Host copy of ``smer_music_generation_tpu/features/controls.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..codec.midi import MidiScore
from ..vocab import CONTROL_BINS, to_category

__all__ = [
    "note_density",
    "bar_track_density",
    "occupation_polyphony_rate",
    "bar_track_occupation_polyphony_rate",
    "pitch_register",
    "to_category",
    "CONTROL_BINS",
]


def _count_notes(track_event: Sequence[str]) -> int:
    """Number of note groups: a ``p_*`` token followed by a non-pitch token."""
    n = 0
    for i in range(len(track_event) - 1):
        if track_event[i][0] == "p" and track_event[i + 1][0] != "p":
            n += 1
    return n


def bar_track_density(track_events: Sequence[Sequence[str]], track_length: int) -> float:
    total = sum(_count_notes(te) for te in track_events)
    return total / track_length


def note_density(
    track_events: Dict[str, List[Sequence[str]]],
    track_length: int,
    total_track_length: int,
) -> Tuple[List[float], Dict[str, List[float]]]:
    """(per-track total densities, per-track per-bar densities).

    ``track_events[name]`` is the list of per-bar token slices for a track;
    density is note groups per 16th slot (reference ``encode.py:27-50``).
    """
    total_track_densities = []
    bar_track_densities: Dict[str, List[float]] = {}
    for track_name, bars in track_events.items():
        bar_counts = [_count_notes(te) for te in bars]
        bar_track_densities[track_name] = [c / track_length for c in bar_counts]
        total_track_densities.append(sum(bar_counts) / total_track_length)
    return total_track_densities, bar_track_densities


def occupation_polyphony_rate(
    score: MidiScore,
    bar_sixteenth_note_number: int,
    sixteenth_notes_time: float,
    bar_num: int,
):
    """Per-track and per-bar occupation/polyphony rates.

    Occupation: fraction of 16th slots with any note; polyphony: fraction of
    occupied slots with >= 2 simultaneous notes (reference
    ``encode.py:155-203``).
    """
    occupation_rate: List[float] = []
    polyphony_rate: List[float] = []
    bar_occupation_rate: Dict[int, List[float]] = {}
    bar_polyphony_rate: Dict[int, List[float]] = {}

    for inst_idx, instrument in enumerate(score.instruments):
        if instrument.is_drum:
            instrument = copy.deepcopy(instrument)
            instrument.is_drum = False
        roll = instrument.get_piano_roll(fs=1 / sixteenth_notes_time)
        occupied = np.any(roll, 0)
        poly = np.count_nonzero(roll, 0) > 1
        if roll.shape[1] == 0:
            occupation_rate.append(0)
        else:
            occupation_rate.append(
                np.count_nonzero(occupied) / (bar_num * bar_sixteenth_note_number)
            )
        if np.count_nonzero(occupied) == 0:
            polyphony_rate.append(0)
        else:
            polyphony_rate.append(np.count_nonzero(poly) / np.count_nonzero(occupied))

        bar_occupation_rate[inst_idx] = []
        bar_polyphony_rate[inst_idx] = []
        for bar_idx in range(bar_num):
            lo = bar_idx * bar_sixteenth_note_number
            if roll.shape[1] < lo:
                bar_occupation_rate[inst_idx].append(0)
                bar_polyphony_rate[inst_idx].append(0)
                continue
            sl = slice(lo, lo + bar_sixteenth_note_number)
            occ = np.count_nonzero(occupied[sl])
            if occ == 0:
                bar_occupation_rate[inst_idx].append(0)
                bar_polyphony_rate[inst_idx].append(0)
            else:
                bar_occupation_rate[inst_idx].append(occ / bar_sixteenth_note_number)
                bar_polyphony_rate[inst_idx].append(np.count_nonzero(poly[sl]) / occ)

    return occupation_rate, polyphony_rate, bar_occupation_rate, bar_polyphony_rate


def bar_track_occupation_polyphony_rate(
    score: MidiScore, sixteenth_notes_time: float
) -> Tuple[float, float]:
    """Single-window occupation/polyphony (reference ``encode.py:136-152``)."""
    try:
        roll = score.get_piano_roll(fs=1 / sixteenth_notes_time)
        occupied = np.any(roll, 0)
        if roll.shape[1] == 0:
            occ_rate = 0.0
        else:
            occ_rate = np.count_nonzero(occupied) / roll.shape[1]
        if np.count_nonzero(occupied) == 0:
            poly_rate = 0.0
        else:
            poly_rate = np.count_nonzero(np.count_nonzero(roll, 0) > 1) / np.count_nonzero(occupied)
        return occ_rate, poly_rate
    except Exception:
        return -1.0, -1.0


def pitch_register(track_events: Dict[str, List[Sequence[str]]]) -> List[int]:
    """Mean pitch register per track, binned to 8 classes over 21..108."""
    registers = []
    for bars in track_events.values():
        pitches = [
            int(tok[2:])
            for te in bars
            for tok in te
            if tok.startswith("p_") and tok[2:].isdigit()
        ]
        if not pitches:
            registers.append(0)
        else:
            mean = float(np.mean(pitches))
            registers.append(int(np.clip((mean - 21) / (108 - 21) * 8, 0, 7)))
    return registers

"""Chew's spiral array: pitch/chord/key geometry, fully vectorized.

Reimplements the geometric core of reference ``tension_calculation.py:22-239``
as precomputed numpy tables: the per-(shift, pitch-class) 3-D positions and
pairwise distance matrices that the tension features reduce over, so the
per-16th-step Python loops of the reference collapse to matmuls.

Host copy of ``smer_music_generation_tpu/features/spiral.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np

OCTAVE = 12

PITCH_INDEX_TO_SHARP_NAMES = np.array(
    ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
)
PITCH_INDEX_TO_FLAT_NAMES = np.array(
    ["C", "D-", "D", "E-", "E", "F", "G-", "G", "A-", "A", "B-", "B"]
)

PITCH_NAME_TO_PITCH_INDEX: Dict[str, int] = {
    "G-": -6, "D-": -5, "A-": -4, "E-": -3, "B-": -2, "F": -1, "C": 0,
    "G": 1, "D": 2, "A": 3, "E": 4, "B": 5, "F#": 6, "C#": 7, "G#": 8,
    "D#": 9, "A#": 10,
}
PITCH_INDEX_TO_PITCH_NAME = {v: k for k, v in PITCH_NAME_TO_PITCH_INDEX.items()}

VALID_MAJOR = ["G-", "D-", "A-", "E-", "B-", "F", "C", "G", "D", "A", "E", "B"]
VALID_MINOR = ["E-", "B-", "F", "C", "G", "D", "A", "E", "B", "F#", "C#", "G#"]

ENHARMONIC_DICT = {"F#": "G-", "C#": "D-", "G#": "A-", "D#": "E-", "A#": "B-"}
ENHARMONIC_REVERSE_DICT = {v: k for k, v in ENHARMONIC_DICT.items()}

ALL_KEY_NAMES = [
    "C major", "G major", "D major", "A major",
    "E major", "B major", "F major", "B- major",
    "E- major", "A- major", "D- major", "G- major",
    "A minor", "E minor", "B minor", "F# minor",
    "C# minor", "G# minor", "D minor", "G minor",
    "C minor", "F minor", "B- minor", "E- minor",
]

# chromatic pitch class -> circle-of-fifths index
# (['C','D-','D','E-','E','F','G-','G','A-','A','B-','B'])
NOTE_INDEX_TO_PITCH_INDEX = np.array([0, -5, 2, -3, 4, -1, -6, 1, -4, 3, -2, 5])

WEIGHT = np.array([0.536, 0.274, 0.19])
ALPHA = 0.75
BETA = 0.75
VERTICAL_STEP = 0.4
RADIUS = 1.0


def pitch_index_to_position(pitch_index) -> np.ndarray:
    """Helix position of circle-of-fifths index; vectorized over arrays."""
    pitch_index = np.asarray(pitch_index)
    c = pitch_index - 4 * (pitch_index // 4)  # mod 4 with floor semantics
    pos = np.zeros(pitch_index.shape + (3,))
    pos[..., 0] = np.where(c == 1, RADIUS, np.where(c == 3, -RADIUS, 0.0))
    pos[..., 1] = np.where(c == 0, RADIUS, np.where(c == 2, -RADIUS, 0.0))
    pos[..., 2] = pitch_index * VERTICAL_STEP
    return pos


# The four position helpers below are pure functions of a small integer
# domain, called thousands of times per file during the dataset build —
# memoized; results are frozen (writeable=False) so the shared arrays
# cannot be mutated by a caller.


def _frozen(arr: np.ndarray) -> np.ndarray:
    arr.flags.writeable = False
    return arr


@lru_cache(maxsize=None)
def major_triad_position(root_index: int) -> np.ndarray:
    root_index = int(root_index)
    root = pitch_index_to_position(root_index)
    fifth = pitch_index_to_position(root_index + 1)
    third = pitch_index_to_position(root_index + 4)
    return _frozen(WEIGHT[0] * root + WEIGHT[1] * fifth + WEIGHT[2] * third)


@lru_cache(maxsize=None)
def minor_triad_position(root_index: int) -> np.ndarray:
    root_index = int(root_index)
    root = pitch_index_to_position(root_index)
    fifth = pitch_index_to_position(root_index + 1)
    third = pitch_index_to_position(root_index - 3)
    return _frozen(WEIGHT[0] * root + WEIGHT[1] * fifth + WEIGHT[2] * third)


@lru_cache(maxsize=None)
def major_key_position(key_index: int) -> np.ndarray:
    key_index = int(key_index)
    return _frozen(
        WEIGHT[0] * major_triad_position(key_index)
        + WEIGHT[1] * major_triad_position(key_index + 1)
        + WEIGHT[2] * major_triad_position(key_index - 1)
    )


@lru_cache(maxsize=None)
def minor_key_position(key_index: int) -> np.ndarray:
    key_index = int(key_index)
    return _frozen(
        WEIGHT[0] * minor_triad_position(key_index)
        + WEIGHT[1]
        * (ALPHA * major_triad_position(key_index + 1) + (1 - ALPHA) * minor_triad_position(key_index + 1))
        + WEIGHT[2]
        * (BETA * minor_triad_position(key_index - 1) + (1 - BETA) * major_triad_position(key_index - 1))
    )


def _class_position_table() -> np.ndarray:
    """``POS[shift, pc]``: helix position of chromatic class ``pc`` under
    key shift ``shift`` (position of ``NOTE_INDEX_TO_PITCH_INDEX[(pc - shift) % 12]``)."""
    shifts = np.arange(12)[:, None]
    pcs = np.arange(12)[None, :]
    shifted = (pcs - shifts) % 12
    return pitch_index_to_position(NOTE_INDEX_TO_PITCH_INDEX[shifted])


CLASS_POSITIONS = _class_position_table()  # (12 shifts, 12 classes, 3)

# pairwise distances between class positions per shift: (12, 12, 12)
CLASS_PAIR_DISTANCES = np.linalg.norm(
    CLASS_POSITIONS[:, :, None, :] - CLASS_POSITIONS[:, None, :, :], axis=-1
)


def note_to_key_pos(note_indices, key_pos) -> np.ndarray:
    """Distances of chromatic notes to a key position (reference
    ``tension_calculation.py:764-769``)."""
    positions = pitch_index_to_position(NOTE_INDEX_TO_PITCH_INDEX[np.asarray(note_indices)])
    return np.linalg.norm(positions - key_pos, axis=-1)


def note_to_note_pos(note_indices, note_pos) -> np.ndarray:
    positions = pitch_index_to_position(NOTE_INDEX_TO_PITCH_INDEX[np.asarray(note_indices)])
    return np.linalg.norm(positions - note_pos, axis=-1)


def chord_to_key_pos(chord_indices, key_pos) -> np.ndarray:
    """Major then minor triad distances (reference ``:779-787``)."""
    majors = [major_triad_position(NOTE_INDEX_TO_PITCH_INDEX[i]) for i in chord_indices]
    minors = [minor_triad_position(NOTE_INDEX_TO_PITCH_INDEX[i]) for i in chord_indices]
    return np.linalg.norm(np.array(majors + minors) - key_pos, axis=-1)


def key_to_key_pos(key_indices, key_pos) -> np.ndarray:
    """Major then minor key distances (reference ``:790-800``)."""
    majors = [major_key_position(NOTE_INDEX_TO_PITCH_INDEX[i]) for i in key_indices]
    minors = [minor_key_position(NOTE_INDEX_TO_PITCH_INDEX[i]) for i in key_indices]
    return np.linalg.norm(np.array(majors + minors) - key_pos, axis=-1)


def class_counts(piano_roll: np.ndarray) -> np.ndarray:
    """Fold a (128, T) roll into per-chromatic-class active counts (12, T)."""
    T = piano_roll.shape[1]
    counts = np.zeros((12, T))
    for start in range(0, 128 - 12 + 1, 12):
        counts += piano_roll[start : start + 12]
    rem = 128 % 12
    if rem:
        counts[:rem] += piano_roll[128 - rem :]
    return counts


def centroids_for_shift(piano_roll: np.ndarray, shift: int) -> np.ndarray:
    """Per-timestep centre of effect (T, 3); zero vector for silent steps.

    Vectorized form of reference ``cal_centroid`` / ``notes_to_ce``
    (``tension_calculation.py:122-143,559-573``).
    """
    counts = class_counts(piano_roll > 0)  # (12, T)
    pos = CLASS_POSITIONS[shift]  # (12, 3)
    totals = counts.sum(axis=0)  # (T,)
    sums = counts.T @ pos  # (T, 3)
    with np.errstate(invalid="ignore", divide="ignore"):
        cent = np.where(totals[:, None] > 0, sums / np.maximum(totals, 1)[:, None], 0.0)
    return cent


def diameters_for_shift(piano_roll: np.ndarray, shift: int) -> np.ndarray:
    """Per-timestep cloud diameter (max pairwise class distance), vectorized.

    Reference ``cal_diameter`` (``tension_calculation.py:66-99``) is an
    O(T * n^2) Python loop; here it is a masked reduction over the
    precomputed (12, 12) distance table.
    """
    active = class_counts(piano_roll > 0) > 0  # (12, T)
    D = CLASS_PAIR_DISTANCES[shift]  # (12, 12)
    pair_active = active[:, None, :] & active[None, :, :]  # (12, 12, T)
    vals = np.where(pair_active, D[:, :, None], 0.0)
    return vals.reshape(144, -1).max(axis=0)

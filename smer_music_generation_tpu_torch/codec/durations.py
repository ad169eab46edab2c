"""Duration-name <-> time tables for the SMER encoding.

Reimplements the duration algebra of reference ``encode.py:213-294`` /
``preprocessing.py:456-517``: the four basic note values plus every 2/3/4
element combination (``half_quarter``, ``quarter_eighth_sixteenth``, ...)
and, for >=4/4 signatures, ``whole``.  Durations are snapped to the nearest
table entry (reference ``time2durations``, ``encode.py:947-954``).

The tables are precomputed as aligned numpy arrays so the snap is a single
vectorized ``argmin``.

Host copy of ``smer_music_generation_tpu/codec/durations.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

BASIC_NAMES = ("half", "quarter", "eighth", "sixteenth")


@dataclass(frozen=True)
class DurationTable:
    """Immutable duration lookup for one (beat_duration, time_signature)."""

    name_to_time: Dict[str, float]
    times: np.ndarray  # sorted
    names_by_time: Tuple[str, ...]  # aligned with `times`
    bar_duration: float
    sixteenth: float

    def time_to_names(self, duration: float) -> List[str]:
        """Snap ``duration`` to the nearest table entry, return name parts.

        Reference ``time2durations``: nearest entry by absolute difference;
        the ``zero`` entry yields an empty list.
        """
        idx = int(np.argmin(np.abs(duration - self.times)))
        name = self.names_by_time[idx]
        if name == "zero":
            return []
        return name.split("_")

    def total_duration(self, duration_names) -> float:
        return float(sum(self.name_to_time[n] for n in duration_names))

    @property
    def minimum_difference(self) -> float:
        return self.sixteenth / 2


@lru_cache(maxsize=256)
def get_duration_table(beat_duration: float, time_signature: Tuple[int, int]) -> DurationTable:
    """Build the table (reference ``get_note_duration_dict``).

    ``beat_duration`` is the *beat* length: the quarter note for ``x/4``
    signatures, the dotted quarter for 6/8.  Memoized — the build calls
    this per bar with a handful of distinct (tempo, signature) pairs, and
    the table is immutable.
    """
    num, den = time_signature
    name_to_time: Dict[str, float] = {}
    if den == 4:
        quarter = beat_duration
        bar_duration = num * quarter
    else:  # 6/8
        quarter = beat_duration / 3 * 2
        bar_duration = num * (quarter / 2)

    name_to_time["half"] = quarter * 2
    name_to_time["quarter"] = quarter
    name_to_time["eighth"] = quarter / 2
    name_to_time["sixteenth"] = quarter / 4

    for r in (2, 3, 4):
        for combo in itertools.combinations(BASIC_NAMES, r):
            name_to_time["_".join(combo)] = sum(name_to_time[n] for n in combo)

    name_to_time["zero"] = 0.0
    if num >= 4 and den == 4:
        name_to_time["whole"] = 4 * quarter

    # later entries win on exact time collisions, matching the reference's
    # dict-inversion order
    time_to_name = {v: k for k, v in name_to_time.items()}
    times = np.sort(np.array(list(time_to_name.keys())))
    names = tuple(time_to_name[t] for t in times)
    return DurationTable(
        name_to_time=name_to_time,
        times=times,
        names_by_time=names,
        bar_duration=float(bar_duration),
        sixteenth=name_to_time["sixteenth"],
    )


def duration_table_for_signature(time_signature: Tuple[int, int], tempo: float) -> DurationTable:
    """Table from tempo alone (beat length derived from the signature)."""
    quarter = 60.0 / tempo
    num, den = time_signature
    if den == 8:
        beat = quarter * 1.5
    else:
        beat = quarter
    return get_duration_table(beat, time_signature)

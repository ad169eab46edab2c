"""Event-stream structure scanning shared across the stack.

The reference re-derives bar/track geometry with near-identical regex +
``np.where`` blocks in at least five places (``dataset.py:99-153``,
``generation.py:248-341,698-877``, ``evaluation.py:439-642``,
``encode.py:602-670``).  This module is the single implementation.

Token stream layout (SURVEY.md §2.3)::

    <time_sig> <t_k> [k_key] [d_*..] [o_*..] [y_*..] <i_prog x n>   # header
    ( bar [s_*] ( track_i [d o y] body [d o y] ) x tracks [s] ) x bars

Host copy of ``smer_music_generation_tpu/codec/structure.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

TRACK_RE = re.compile(r"track_\d")
PROGRAM_RE = re.compile(r"i_\d")

__all__ = [
    "TRACK_RE",
    "PROGRAM_RE",
    "track_names_of",
    "programs_of",
    "bar_positions",
    "bar_with_track_positions",
    "split_track_events",
]


def _is_track_token(e: str) -> bool:
    # same predicate as TRACK_RE.match (unanchored prefix match)
    return e.startswith("track_") and len(e) > 6 and e[6].isdigit()


def track_names_of(events: Sequence[str]) -> List[str]:
    return sorted({e for e in events if _is_track_token(e)})


def programs_of(events: Sequence[str]) -> List[str]:
    return [e for e in events if e.startswith("i_") and len(e) > 2 and e[2].isdigit()]


def bar_positions(events: Sequence[str]) -> np.ndarray:
    return np.fromiter(
        (i for i, e in enumerate(events) if e == "bar"), np.int64
    )


def bar_with_track_positions(
    events: Sequence[str],
) -> Tuple[List[str], np.ndarray, List[List[Tuple[int, int]]]]:
    """Per bar, per track: (start, end) of the track body slice.

    ``start`` is the index just after the ``track_i`` token; ``end`` is the
    index of the next ``track_j`` / ``bar`` token (or end of stream).
    Matches the reference's ``bar_with_track_poses`` construction
    (``dataset.py:376-400``); one pass, no string-object array.
    """
    seen = set()
    bar_list: List[int] = []
    all_pos: List[int] = []
    for i, e in enumerate(events):
        if e == "bar":
            bar_list.append(i)
            all_pos.append(i)
        elif _is_track_token(e):
            seen.add(e)
            all_pos.append(i)
    track_names = sorted(seen)
    track_nums = len(track_names)
    bar_poses = np.asarray(bar_list, dtype=np.int64)
    all_pos.append(len(events))

    bars: List[List[Tuple[int, int]]] = []
    this_bar: List[int] = []
    for i, pos in enumerate(all_pos[1:]):
        if i % (track_nums + 1) == 0:
            this_bar = [pos]
        else:
            this_bar.append(pos)
            if i % (track_nums + 1) == track_nums:
                bars.append(
                    [(this_bar[j] + 1, this_bar[j + 1]) for j in range(len(this_bar) - 1)]
                )
    return track_names, bar_poses, bars


def split_track_events(events: Sequence[str]) -> Dict[str, List[np.ndarray]]:
    """Per-track list of per-bar event slices, each starting at the
    ``track_i`` token (reference ``encode.py:612-670``)."""
    arr = np.array(events)
    track_names = track_names_of(events)
    bar_poses = np.where(arr == "bar")[0]
    out: Dict[str, List[np.ndarray]] = {name: [] for name in track_names}

    for bar_index in range(len(bar_poses)):
        lo = bar_poses[bar_index]
        hi = bar_poses[bar_index + 1] if bar_index + 1 < len(bar_poses) else len(arr)
        bar_events = arr[lo:hi]
        track_pos = [int(np.where(bar_events == name)[0][0]) for name in track_names]
        for ti, name in enumerate(track_names):
            end = track_pos[ti + 1] if ti + 1 < len(track_names) else len(bar_events)
            out[name].append(bar_events[track_pos[ti] : end])
    return out

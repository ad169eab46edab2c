"""ctypes front end for the native SMER tokenizer core.

``bar_notes_to_event_native`` is a drop-in replacement for
``codec.smer.bar_notes_to_event`` (same inputs/outputs); it marshals the
bar's notes into flat arrays, calls the C++ core, and expands the returned
token codes back into strings via the duration table.

The call is made once per (bar, track) — thousands of times per file in
the dataset build — so the marshalling layer is kept allocation-free on
the hot path: output scratch buffers live in thread-local storage with
prebuilt ctypes pointers, and everything derived from the duration table
(the contiguous times array, the ``zero`` index, the pre-split token
names) is computed once per table and memoized on it.

Copy of ``smer_music_generation_tpu/native/tokenizer.py`` for the PyTorch
port; ``CALLS`` counts the bars and tracks the core tokenized in this
process.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..codec.durations import DurationTable
from ..codec.midi import Note
from . import load_library

MAX_TOKENS = 4096
MAX_CONT = 256

_scratch = threading.local()
CALLS = {"bar": 0, "track": 0}


def native_available() -> bool:
    return load_library() is not None


def _get_scratch():
    s = getattr(_scratch, "bufs", None)
    if s is None:
        out = np.zeros(MAX_TOKENS, dtype=np.int32)
        cont_pitches = np.zeros(MAX_CONT, dtype=np.int32)
        cont_ends = np.zeros(MAX_CONT, dtype=np.float64)
        s = (
            out, out.ctypes.data,
            cont_pitches, cont_pitches.ctypes.data,
            cont_ends, cont_ends.ctypes.data,
        )
        _scratch.bufs = s
    return s


def _table_cache(table: DurationTable):
    """(times address, n_times, zero index, pre-split names) for one table.

    DurationTable is a frozen dataclass; the cache is attached through
    ``object.__setattr__`` so repeated bars of the same table skip the
    contiguous copy, the linear ``index`` scan, and the ``str.split``.
    """
    cached = table.__dict__.get("_native_tok")
    if cached is None:
        dur_times = np.ascontiguousarray(table.times, dtype=np.float64)
        cached = (
            dur_times,  # keep the buffer alive alongside its address
            dur_times.ctypes.data,
            len(dur_times),
            table.names_by_time.index("zero"),
            tuple(name.split("_") for name in table.names_by_time),
        )
        object.__setattr__(table, "_native_tok", cached)
    return cached


def _expand_codes(codes, names_split) -> List[str]:
    tokens: List[str] = []
    for code in codes:
        if code == -1:
            tokens.append("rest")
        elif code == -2:
            tokens.append("sep")
        elif code == -3:
            tokens.append("continue")
        elif code >= 2000:
            tokens.extend(names_split[code - 2000])
        else:
            tokens.append(f"p_{code - 1000}")
    return tokens


def track_notes_to_events_native(
    notes: List[Note],
    down_beats,
    beats,
    dbi: Sequence[int],
    tables: List[DurationTable],
    grid_division: int = 4,
    is_grid: bool = True,
) -> Optional[List[List[str]]]:
    """Tokenize every bar of one track in ONE native call.

    ``notes`` must be start-sorted and pitch-filtered; ``tables`` holds the
    per-bar duration table (usually one distinct table).  Tie/continue
    carry between bars happens inside the C++ core.  Returns the per-bar
    token lists, or None when the library (or the track symbol) is
    unavailable or the output overflows — callers fall back to the
    per-bar path.
    """
    lib = load_library()
    if lib is None:
        return None
    n_bars = len(tables)
    if n_bars == 0:
        return []

    n = len(notes)
    starts = np.fromiter((x.start for x in notes), np.float64, n)
    ends = np.fromiter((x.end for x in notes), np.float64, n)
    pitches = np.fromiter((x.pitch for x in notes), np.int32, n)
    down_beats = np.ascontiguousarray(down_beats, dtype=np.float64)
    beats = np.ascontiguousarray(beats, dtype=np.float64)
    dbi_arr = np.ascontiguousarray(dbi, dtype=np.int32)

    # dedup tables (by identity: get_duration_table is memoized) into a
    # padded (n_tables, stride) times matrix + per-table metadata
    table_ids: Dict[int, int] = {}
    uniq: List[DurationTable] = []
    bar_table = np.empty(n_bars, np.int32)
    for b, t in enumerate(tables):
        idx = table_ids.get(id(t))
        if idx is None:
            idx = len(uniq)
            table_ids[id(t)] = idx
            uniq.append(t)
        bar_table[b] = idx
    stride = max(len(t.times) for t in uniq)
    times_mat = np.zeros((len(uniq), stride), np.float64)
    table_n = np.empty(len(uniq), np.int32)
    table_zero = np.empty(len(uniq), np.int32)
    table_md = np.empty(len(uniq), np.float64)
    names_by_table = []
    for k, t in enumerate(uniq):
        dur_times, _, n_dur, zero_index, names_split = _table_cache(t)
        times_mat[k, :n_dur] = dur_times
        table_n[k] = n_dur
        table_zero[k] = zero_index
        table_md[k] = t.minimum_difference
        names_by_table.append(names_split)

    max_out = 4096 + 8 * n + 16 * n_bars
    out = np.zeros(max_out, np.int32)
    offsets = np.zeros(n_bars + 1, np.int32)

    n_out = lib.smer_tokenize_track(
        starts.ctypes.data, ends.ctypes.data, pitches.ctypes.data, n,
        down_beats.ctypes.data, n_bars,
        beats.ctypes.data, dbi_arr.ctypes.data,
        grid_division, int(is_grid),
        times_mat.ctypes.data, table_n.ctypes.data,
        table_zero.ctypes.data, table_md.ctypes.data,
        stride, bar_table.ctypes.data,
        out.ctypes.data, max_out, offsets.ctypes.data,
    )
    if n_out < 0:
        return None
    CALLS["track"] += 1

    codes = out[:n_out].tolist()
    offs = offsets.tolist()
    return [
        _expand_codes(codes[offs[b] : offs[b + 1]], names_by_table[bar_table[b]])
        for b in range(n_bars)
    ]


def bar_notes_to_event_native(
    notes: List[Note],
    bar_time: float,
    next_bar_time: float,
    beat_times: Sequence[float],
    table: DurationTable,
    minimum_difference: float,
    grid_division: int = 4,
    is_grid: bool = True,
) -> Optional[Tuple[List[str], Dict[int, Note]]]:
    """Native per-bar tokenization; None if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None

    n = len(notes)
    starts = np.fromiter((x.start for x in notes), np.float64, n)
    ends = np.fromiter((x.end for x in notes), np.float64, n)
    pitches = np.fromiter((x.pitch for x in notes), np.int32, n)
    velocities = np.fromiter((x.velocity for x in notes), np.int32, n)
    beats = np.ascontiguousarray(beat_times, dtype=np.float64)
    _, dur_addr, n_dur, zero_index, names_split = _table_cache(table)
    out, out_addr, cont_pitches, cont_p_addr, cont_ends, cont_e_addr = _get_scratch()
    n_cont = ctypes.c_int32(0)

    n_out = lib.smer_tokenize_bar(
        starts.ctypes.data, ends.ctypes.data,
        pitches.ctypes.data, velocities.ctypes.data, n,
        bar_time, next_bar_time,
        beats.ctypes.data, len(beats),
        minimum_difference, grid_division, int(is_grid),
        dur_addr, n_dur, zero_index,
        out_addr, MAX_TOKENS,
        cont_p_addr, cont_e_addr,
        MAX_CONT, ctypes.addressof(n_cont),
    )
    if n_out < 0:
        return None
    CALLS["bar"] += 1

    tokens = _expand_codes(out[:n_out].tolist(), names_split)

    continue_dict: Dict[int, Note] = {}
    for i in range(n_cont.value):
        pitch = int(cont_pitches[i])
        continue_dict[pitch] = Note(
            velocity=-1, pitch=pitch, start=next_bar_time, end=float(cont_ends[i])
        )
    return tokens, continue_dict

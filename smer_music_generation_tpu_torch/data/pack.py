"""Window validation + greedy length packing into training groups.

Reimplements reference ``load_dataset.py:167-289``: structural validation of
the control header layout, length sort, exact-duplicate removal, greedy
packing into groups of <= ``max_token_length`` tokens, and the
``batch_lengths`` (group size -> group indices) index.

Host copy of ``smer_music_generation_tpu/data/pack.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..codec.structure import programs_of, track_names_of
from ..vocab import (
    TRACK_NOTE_DENSITY_TOKENS,
    TRACK_OCCUPATION_RATE_TOKENS,
    TRACK_POLYPHONY_RATE_TOKENS,
)

MAX_TOKEN_LENGTH = 2200


def validate_window(event: Sequence[str]) -> bool:
    """Header-layout checks (reference ``load_dataset.py:189-232``)."""
    track_names = track_names_of(event)
    track_nums = len(programs_of(event))
    if track_nums != len(track_names) or track_nums == 0:
        return False
    has = lambda prefix: any(t.startswith(prefix) and t[2:].isdigit() for t in event)
    if has("d_"):
        for tok in event[3 : 3 + track_nums]:
            if tok not in TRACK_NOTE_DENSITY_TOKENS:
                return False
    if has("o_"):
        for tok in event[3 + track_nums : 3 + track_nums * 2]:
            if tok not in TRACK_OCCUPATION_RATE_TOKENS:
                return False
    if has("y_"):
        for tok in event[3 + track_nums * 2 : 3 + track_nums * 3]:
            if tok not in TRACK_POLYPHONY_RATE_TOKENS:
                return False
    return True


def pack_windows(
    windows: Sequence[Sequence[str]],
    max_token_length: int = MAX_TOKEN_LENGTH,
) -> Tuple[List[List[List[str]]], Dict[int, List[int]]]:
    """Sort by length, dedup, greedy-pack; returns (groups, batch_lengths).

    Parity notes (reference ``load_dataset.py:252-279``): dedup compares
    ADJACENT entries after a length-only stable sort, so equal windows
    separated by a different same-length window survive — as in the
    reference; and the packing comparison is strict ``<``, so a group
    total never reaches ``max_token_length`` exactly.  Both kept as-is:
    packed pickles are byte-compared against recorded outputs in tests.
    """
    items = [list(w) for w in windows]
    items.sort(key=len)
    deduped: List[List[str]] = []
    for w in items:
        if deduped and w == deduped[-1]:
            continue
        deduped.append(w)

    groups: List[List[List[str]]] = []
    current_len = 0
    for w in deduped:
        if len(w) > max_token_length:
            continue
        if groups and current_len + len(w) < max_token_length:
            groups[-1].append(w)
            current_len += len(w)
        else:
            groups.append([w])
            current_len = len(w)

    batch_lengths: Dict[int, List[int]] = {}
    for index, group in enumerate(groups):
        batch_lengths.setdefault(len(group), []).append(index)
    return groups, batch_lengths


def stack_control_files(
    control_files: Sequence[str],
    max_token_length: int = MAX_TOKEN_LENGTH,
    validate: bool = True,
) -> Tuple[List[List[List[str]]], Dict[int, List[int]]]:
    """Load pickled window lists, validate, pack (reference script tail)."""
    windows: List[List[str]] = []
    for path in control_files:
        with open(path, "rb") as f:
            events = pickle.load(f)
        for event in events:
            event = list(event)
            if validate and not validate_window(event):
                continue
            windows.append(event)
    return pack_windows(windows, max_token_length)


def save_batches(groups, batch_lengths, out_prefix: str) -> None:
    with open(out_prefix + "_batch", "wb") as f:
        pickle.dump(groups, f)
    with open(out_prefix + "_batch_lengths", "wb") as f:
        pickle.dump(batch_lengths, f)


def load_batches(prefix: str):
    with open(prefix + "_batch", "rb") as f:
        groups = pickle.load(f)
    with open(prefix + "_batch_lengths", "rb") as f:
        lengths = pickle.load(f)
    return groups, lengths


def split_train_valid_test(
    control_files: Sequence[str],
    train_ratio: float = 0.8,
    valid_ratio: float = 0.1,
    seed: int = 99,
) -> Tuple[List[str], List[str], List[str]]:
    files = list(control_files)
    rng = np.random.default_rng(seed)
    rng.shuffle(files)
    n = len(files)
    n_train = int(n * train_ratio)
    n_valid = int(n * valid_ratio)
    return (
        files[:n_train],
        files[n_train : n_train + n_valid],
        files[n_train + n_valid :],
    )

"""CLI: standalone tension analysis over MIDI files.

Covers the reference's ``python tension_calculation.py`` surface
(``tension_calculation.py:733-962``): walk a folder (or take one file),
compute per-bar/-window tensile strain and cloud diameter via the spiral
array, and write per-file pickles plus a ``files_result.json`` summary
``{file: [key_name, key_change_time, key_change_bar, key_change_name]}``.

Documented divergence: the reference's live ``__main__`` is dead code — it
calls its own ``cal_tension`` with a mismatched argument list (10
positionals at ``:927`` against the 9-parameter signature at ``:370``) and
unpacks 8 return values where 5 are returned, so it raises ``TypeError``
on any input.  This CLI implements the *intended* behavior: the summary
JSON the ``__main__`` builds, per-file ``.tension``/``.diameter`` pickles
(the artifact shape its commented-out predecessor ``:823-852`` consumed),
and optional key-change detection behind ``-k`` (the reference gates it on
``len(down_beat_time) > 9999999``, i.e. never).

Copy of ``smer_music_generation_tpu/features/tension_cli.py`` for the
PyTorch port (pure host work, no device):

    python -m smer_music_generation_tpu_torch.features.tension_cli \
        -i midi_dir -o out_dir [-k]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import sys

import numpy as np

from ..codec.midi import read_midi
from ..data.build import walk_midi as walk
from ..utils.logging import logger_init
from .tension import (
    ALL_KEY_NAMES,
    cal_tension,
    detect_key_change,
    extract_notes,
    key_after_change,
)


def analyze_file(
    path: str,
    window_size: int = -1,
    key_name: str = "",
    track_num: int = 0,
    end_ratio: float = 0.5,
    key_changed: bool = False,
):
    """(tensile, diameter, key_name, key_change_time, key_change_bar,
    key_change_name) for one MIDI file, or None if unanalyzable."""
    score = read_midi(path)
    grid = extract_notes(score, track_num)  # 0 = all tracks
    if grid is None:
        return None
    keys = [key_name] if key_name else ALL_KEY_NAMES
    result = cal_tension(
        grid.piano_roll,
        grid.beat_time,
        grid.beat_indices,
        grid.down_beat_time,
        grid.down_beat_indices,
        window_size,
        keys,
        end_ratio=end_ratio,
    )
    if result is None:
        return None
    tensile, diameter, found_key, change_name, _ = result
    if not np.count_nonzero(tensile) or not np.count_nonzero(diameter):
        return None
    change_time, change_bar = -1.0, -1
    if key_changed:
        # detection always runs on BAR windows (the reference's key-change
        # branch computes its detection series at window -1, :378-390),
        # independent of the -w reporting window
        if window_size == -1:
            bar_tensile, bar_diam = tensile, diameter
        else:
            bar_result = cal_tension(
                grid.piano_roll, grid.beat_time, grid.beat_indices,
                grid.down_beat_time, grid.down_beat_indices, -1, keys,
                end_ratio=end_ratio,
            )
            if bar_result is None:
                return tensile, diameter, found_key, change_time, change_bar, change_name
            bar_tensile, bar_diam = bar_result[0], bar_result[1]
        change_bar = detect_key_change(bar_tensile, bar_diam, start_ratio=end_ratio)
        if change_bar != -1 and change_bar < len(grid.down_beat_indices):
            change_time = float(grid.down_beat_time[change_bar])
            after = key_after_change(
                grid.piano_roll, int(grid.down_beat_indices[change_bar])
            )
            if after is not None and after[0] != found_key:
                change_name = after[0]
            else:
                change_time, change_bar = -1.0, -1
        else:
            change_bar = -1
    return tensile, diameter, found_key, change_time, change_bar, change_name


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_folder", default=".")
    parser.add_argument("-f", "--file_name", default="",
                        help="analyze a single MIDI file instead of a folder")
    parser.add_argument("-o", "--output_folder", default=".")
    parser.add_argument("-w", "--window_size", default=-1, type=int,
                        help="window in beats; -1 = one bar")
    parser.add_argument("-n", "--key_name", default="",
                        help='fixed key, e.g. "B- major"; default: detect')
    parser.add_argument("-t", "--track_num", default=0, type=int,
                        help="use first N tracks (0 = all)")
    parser.add_argument("-r", "--end_ratio", default=0.5, type=float,
                        help="fraction of the song used to find the first key")
    parser.add_argument("-k", "--key_changed", action="store_true",
                        help="also run key-change detection")
    parser.add_argument("-v", "--vertical_step", default=0.4, type=float,
                        help="spiral-array vertical step (informational; the "
                        "spiral tables are built at the reference's 0.4)")
    args = parser.parse_args(argv)

    out_dir = os.path.abspath(args.output_folder)
    os.makedirs(out_dir, exist_ok=True)
    logger = logger_init(os.path.join(out_dir, "tension_calculate.log"))
    if not (math.sqrt(2 / 15) <= args.vertical_step <= math.sqrt(0.2)):
        logger.info("invalid vertical step, use 0.4 instead")

    files = [args.file_name] if args.file_name else walk(args.input_folder)
    files_result = {}
    for path in files:
        # collision-safe artifact name: relative path with separators
        # folded, so a/song.mid and b/song.mid don't overwrite each other
        if args.file_name:
            base = os.path.basename(path)
        else:
            base = os.path.relpath(path, args.input_folder).replace(os.sep, "_")
        try:
            result = analyze_file(
                path,
                window_size=args.window_size,
                key_name=args.key_name,
                track_num=args.track_num,
                end_ratio=args.end_ratio,
                key_changed=args.key_changed,
            )
        except Exception as exc:  # corpus tool: one bad file must not
            logger.info(f"unexpected error in {path}: {exc!r}")  # kill the run
            continue
        if result is None:
            logger.info(f"cannot analyze {path}, skip this file")
            continue
        tensile, diameter, key, change_time, change_bar, change_name = result
        stem = os.path.join(out_dir, base)
        with open(stem + ".tension", "wb") as fh:
            pickle.dump(np.asarray(tensile), fh)
        with open(stem + ".diameter", "wb") as fh:
            pickle.dump(np.asarray(diameter), fh)
        files_result[stem] = [
            key, round(float(change_time), 3), int(change_bar), change_name,
        ]
    logger.info(str(len(files_result)))
    with open(os.path.join(out_dir, "files_result.json"), "w") as fh:
        json.dump(files_result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())

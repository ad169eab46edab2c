"""CLI: bulk MIDI -> annotated windows -> packed training batches.

Port of ``smer_music_generation_tpu/data/build_cli.py`` (the reference's
``preprocessing.py`` + ``create_dataset.py`` + ``load_dataset.py``
command-line surface in one tool):

    python -m smer_music_generation_tpu_torch.data.build_cli \\
        -i midi_dir -o out_dir [--mode 0] [--augment] [--jobs 8] [--pack]

``--pack`` also writes the ``<prefix>_{training,validation,test}`` splits that
the trainer and ``eval/eval_cli.py`` read.  Pure host work: SMER
tokenization runs the C++ core of ``native/`` (built at first use under
``build/native/``) when g++ is there, and the log says whether it was.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import native
from ..native import tokenizer as native_tokenizer
from ..utils.logging import logger_init
from .build import build_corpus, walk_midi
from .pack import save_batches, split_train_valid_test, stack_control_files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_folder", required=True)
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("-m", "--mode", type=int, default=0, help="0=SMER, 1=REMI")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--no_bar_controls", action="store_true")
    parser.add_argument("-j", "--jobs", type=int, default=0)
    parser.add_argument("--pack", action="store_true", help="also pack into batches")
    parser.add_argument("--max_token_length", type=int, default=2200)
    args = parser.parse_args(argv)

    logger = logger_init(os.path.join(args.output_folder, "build.log"))
    files = walk_midi(args.input_folder)
    logger.info(f"{len(files)} MIDI files under {args.input_folder}")
    t0 = time.perf_counter()
    control_files = build_corpus(
        files,
        args.output_folder,
        mode=args.mode,
        augment=args.augment,
        add_bar=not args.no_bar_controls,
        n_jobs=args.jobs,
    )
    dt = time.perf_counter() - t0
    rate = len(files) / dt if dt > 0 else 0.0
    logger.info(
        f"built {len(control_files)}/{len(files)} files in {dt:.1f}s ({rate:.2f} files/s)"
    )
    if native.load_library() is None:
        logger.info(f"native tokenizer: not loaded ({native.BUILD_INFO['error']}); Python fallback")
    else:
        # the counts cover this process only (not --jobs workers)
        logger.info(f"native tokenizer: loaded {native.BUILD_INFO['path']}; "
                    f"tokenized {native_tokenizer.CALLS['track']} tracks, "
                    f"{native_tokenizer.CALLS['bar']} bars in this process")

    if args.pack and control_files:
        train_f, valid_f, test_f = split_train_valid_test(control_files)
        prefix = "smer" if args.mode == 0 else "remi"
        for split, split_files in (
            ("training", train_f), ("validation", valid_f), ("test", test_f),
        ):
            if not split_files:
                continue
            groups, lengths = stack_control_files(split_files, args.max_token_length)
            out_prefix = os.path.join(args.output_folder, f"{prefix}_{split}")
            save_batches(groups, lengths, out_prefix)
            logger.info(f"{split}: {len(groups)} packed groups -> {out_prefix}_batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: controllability evaluation over a packed test split, with the PyTorch port.

Port of ``smer_music_generation_tpu/eval/eval_cli.py``:

    python -m smer_music_generation_tpu_torch.eval.eval_cli \\
        --checkpoint ... --test_batches path/smer_test [--max_windows 20] \\
        [--device cpu]

The model computes in bf16 on CUDA and in f32 on the CPU.  The sweep's
requests go through ``InfillEngine``: with ``--max_time_fix_attempts 0`` each
(window, kind) is one ``run_batch`` decode (the v3 kernels on CUDA); with
retries, or with ``--correct_controls``, the engine's settle loop runs the
plain forced-prefix loop.  With no ``--checkpoint`` the weights are random.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..data.masking import copy_bar_controls_to_end
from ..data.pack import load_batches
from ..infer.engine import InfillEngine
from ..train.state import load_inference_model
from ..utils.config import ExperimentConfig
from ..utils.logging import logger_init
from ..vocab import WordVocab
from .controllability import ControllabilityEvaluator


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--test_batches", type=str, required=True)
    parser.add_argument("--output", type=str, default="eval_results.json")
    parser.add_argument("--max_windows", type=int, default=20)
    parser.add_argument("--unk_mode", type=int, default=0, choices=[0, 1, 2, 3])
    parser.add_argument("--correct_controls", action="store_true",
                        help="in-decode use_correct_control substitution "
                        "(reference evaluation.py:1217-1288)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kinds", type=str, default=None,
                        help="comma-separated subset of control kinds to "
                        "evaluate (e.g. 'tensile'); default: every kind "
                        "the model was trained with")
    parser.add_argument("--max_time_fix_attempts", type=int, default=10,
                        help="per-group bar-duration regeneration budget "
                        "(reference evaluation.py:1300-1397); 0 = single "
                        "decode per window (fast smoke evals)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    logger = logger_init(None)
    device = torch.device(args.device)
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, epoch = load_inference_model(
        cfg, vocab.vocab_size, args.checkpoint, dtype, device=device, seed=args.seed
    )
    if args.checkpoint:
        logger.info(f"loaded checkpoint {args.checkpoint} (epoch {epoch})")
    else:
        logger.warning("evaluating RANDOM weights (no --checkpoint)")

    groups, _ = load_batches(args.test_batches)
    windows = [[str(t) for t in w] for g in groups for w in g]
    # same stream prep as training (MaskingPipeline.prepare_group): strip
    # control families outside this model's vocab
    basic, ctrl = set(vocab.basic_tokens), set(vocab.control_tokens)
    windows = [[t for t in w if t in basic or t in ctrl] for w in windows]
    if cfg.control_mode == 2:
        # stored windows carry leading copies only; a control-mode-2 model
        # was trained on streams with end-of-track duplication (reference
        # evaluation.py:1916-1956)
        n_types = sum(
            1 for k in ("density", "occupation", "polyphony")
            if k in vocab.class_names
        )
        tension = "tensile" in vocab.class_names
        windows = [
            copy_bar_controls_to_end(w, vocab, n_types, tension) for w in windows
        ]
    logger.info(f"{len(windows)} test windows")

    engine = InfillEngine(
        model, vocab,
        max_time_fix_attempts=args.max_time_fix_attempts,
    )
    evaluator = ControllabilityEvaluator(
        engine, vocab, unk_mode=args.unk_mode,
        correct_controls=args.correct_controls,
    )
    # only the control families this model was trained with are evaluable
    active_kinds = [
        k for k in ("tensile", "density", "occupation", "polyphony")
        if k in vocab.class_names
    ]
    if args.kinds:
        requested = [k.strip() for k in args.kinds.split(",") if k.strip()]
        unknown = set(requested) - set(active_kinds)
        if unknown:
            parser.error(f"--kinds not evaluable for this model: {sorted(unknown)}")
        active_kinds = [k for k in active_kinds if k in requested]
    results = evaluator.run(
        windows, control_kinds=active_kinds, seed=args.seed,
        max_windows=args.max_windows,
    )
    for k, v in results.items():
        if k == "time_stats":
            logger.info(
                f"time repair: mean corrections {v['mean_corrections']} "
                f"failed rate {v['failed_rate']}"
            )
            continue
        logger.info(f"{k}: n={v['n']} mean |set-achieved| = {v['mean_abs_diff']}")
        for fam, kinds in v.get("secondary", {}).items():
            for k2, s in kinds.items():
                logger.info(
                    f"  {fam}/{k2}: n={s['n']} mean={s['mean']:+.2f} "
                    f"mean|.|={s['mean_abs']:.2f}"
                )
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    logger.info(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

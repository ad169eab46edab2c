"""CLI: infill bars/tracks of a MIDI file end to end with the PyTorch port.

Port of ``smer_music_generation_tpu/infer/generate_cli.py`` (encode ->
change controls -> generate -> decode -> write):

    python -m smer_music_generation_tpu_torch.infer.generate_cli \\
        -i song.mid -o out.mid --tracks 0 --bars 4 5 6 7 \\
        [--checkpoint ...] [--greedy] [--p 0.9] [--temperature 1.0] [--draft_k 8] \
        [--correct_controls] [--device cpu]

With no ``--checkpoint`` and no ``--config`` it loads the committed
trained snapshot ``assets/flagship_params.msgpack``; ``--checkpoint
random`` gives random weights.  The model computes in bf16 on CUDA and in
f32 on the CPU.  ``--draft_k K`` decodes the request by speculative decode,
verifying K prompt-lookup drafts a step (on CUDA through the verify kernel,
K <= 15).  ``--correct_controls`` rewrites each regenerated slot's control
copies with the measured controls of its body after the decode.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..codec.annotate import encode_midi
from ..codec.midi import read_midi
from ..codec.smer import events_to_midi
from ..train.state import default_flagship_snapshot, load_inference_model
from ..utils.config import ExperimentConfig
from ..utils.logging import logger_init
from ..vocab import WordVocab
from .engine import InfillEngine, change_controls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--tracks", type=int, nargs="+", default=[0])
    parser.add_argument("--bars", type=int, nargs="+", required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--p", type=float, default=0.9)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--correct_controls", action="store_true")
    parser.add_argument("--max_tgt", type=int, default=1024)
    parser.add_argument("--draft_k", type=int, default=0,
                        help="speculative decode: prompt-lookup draft width (0 = off); greedy output is bit-identical, nucleus distribution-identical")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    logger = logger_init(None)
    device = torch.device(args.device)
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.checkpoint == "random":
        args.checkpoint = None
    elif args.checkpoint is None and args.config is None and cfg.vocab_mode == 0:
        args.checkpoint = default_flagship_snapshot()
        if args.checkpoint:
            logger.info("no --checkpoint: using the committed trained "
                        "snapshot (pass '--checkpoint random' for random "
                        "weights)")
    model, epoch = load_inference_model(
        cfg, vocab.vocab_size, args.checkpoint, dtype, device=device, seed=args.seed
    )
    if args.checkpoint:
        logger.info(f"loaded checkpoint {args.checkpoint} (epoch {epoch})")
    else:
        logger.warning("generating with RANDOM weights (no --checkpoint)")

    score = read_midi(args.input)
    track_names = [f"track_{i}" for i in range(min(len(score.instruments), 3))]
    result = encode_midi(score, controls={"key": None}, track_names=track_names)
    if result is None:
        logger.error("encode failed (unsupported time signature or empty file)")
        return 1
    events, controls = result
    if vocab.mode == 1:
        from ..codec.remi import smer_to_remi

        events = smer_to_remi(events)
    controls["bar_track"] = 0
    for name in track_names:
        controls[f"{name}_c"] = controls[name]
    events = change_controls(events, controls, vocab)

    engine = InfillEngine(
        model, vocab, nucleus_p=None if args.greedy else args.p,
        temperature=args.temperature, greedy=args.greedy,
        max_tgt_len=args.max_tgt,
        # with random weights the bar-closure retry loop always exhausts
        max_time_fix_attempts=10 if args.checkpoint else 0,
        draft_k=args.draft_k,
        seed=args.seed,
    )
    gen = engine(events, args.tracks, args.bars, correct_controls=args.correct_controls)
    if gen is None:
        logger.error("generation failed")
        return 1
    tempo = float(score.get_tempo_changes()[1][0])
    if vocab.mode == 1:
        from ..codec.remi import remi_to_midi

        out = remi_to_midi(gen.events, tempo)
    else:
        out = events_to_midi(gen.events, tempo)
    if out is None:
        logger.error("decode of generated stream failed")
        return 1
    out.write(args.output)
    logger.info(
        f"infilled tracks {args.tracks} bars {args.bars} "
        f"({gen.decode_steps} decode steps) -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

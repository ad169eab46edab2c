"""CLI: start the infilling HTTP server on the PyTorch port.

Port of ``smer_music_generation_tpu/serve/serve_cli.py``:

    python -m smer_music_generation_tpu_torch.serve.serve_cli \\
        [--checkpoint PATH|random] [--port 5000] [--device cpu] [--dp N]

With no ``--checkpoint`` and no ``--config`` it serves the committed
trained snapshot ``assets/flagship_params.msgpack``; ``--checkpoint
random`` gives random weights.  On CUDA (the default) the model computes
in bf16 and decodes through the v3 kernels; on the CPU it computes in f32
through the plain loop.  A missing card raises.  ``--draft_k K`` decodes a
request that arrives alone by speculative decode (the verify kernel on
CUDA, K <= 15); requests the batcher groups go through v3.  ``--dp N``
shards each batch's rows over ``cuda:0`` to ``cuda:{N-1}`` (one model and
one set of graphs a card); an N above the device count logs the error and
returns 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..parallel.mesh import make_mesh
from ..train.state import default_flagship_snapshot, load_inference_model
from ..utils.config import ExperimentConfig
from ..utils.logging import logger_init
from ..vocab import WordVocab
from .app import ServingContext, serve


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--nucleus_p", type=float, default=0.9)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--batch_window_ms", type=float, default=8.0,
                        help="coalesce concurrent /generate requests into "
                        "batched decodes for up to this many ms (0 = off)")
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--draft_k", type=int, default=0,
                        help="speculative decode of single requests: prompt-lookup draft "
                        "width (0 = off; at most 15 on CUDA)")
    parser.add_argument("--dp", type=int, default=0,
                        help="shard batched serving over a dp mesh of N cards "
                        "(0/1 = one card)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    logger = logger_init(None)
    device = torch.device(args.device)
    mesh = None
    if args.dp > 1:
        n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
        if args.dp > n_avail:
            logger.error(f"--dp {args.dp} exceeds the {n_avail} available device(s)")
            return 1
        mesh = make_mesh(args.dp, tp=1)
        device = mesh.dp_devices()[0]
        logger.info(f"dp-sharded serving over {args.dp} devices")
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.checkpoint == "random":
        args.checkpoint = None
    elif args.checkpoint is None and args.config is None and cfg.vocab_mode == 0:
        args.checkpoint = default_flagship_snapshot()
        if args.checkpoint:
            logger.info("no --checkpoint: serving the committed trained "
                        "snapshot (pass '--checkpoint random' for random "
                        "weights)")
    model, epoch = load_inference_model(cfg, vocab.vocab_size, args.checkpoint, dtype, device=device)
    if args.checkpoint:
        logger.info(f"loaded checkpoint {args.checkpoint} (epoch {epoch}) onto {device}")
    else:
        logger.warning("serving with RANDOM weights (no --checkpoint given)")

    ctx = ServingContext(
        model, vocab, nucleus_p=args.nucleus_p, temperature=args.temperature,
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch, mesh=mesh,
        draft_k=args.draft_k,
    )
    server = serve(ctx, host=args.host, port=args.port)
    logger.info(f"serving on {server.server_address}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        server.server_close()
        ctx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The decode graphs a served mix of requests needs, and the share of decodes
that find theirs.

On CUDA the decoder keeps the CUDA graphs of its v3 token loop in a
``GraphCache`` keyed by the batch size B and the source's padding bucket;
a decode whose key is new pays the kernels' warm-up and a capture.  This
script serves a seeded mix of infill requests through the server's own
``MicroBatcher`` (window 8 ms, batches of at most 8) and ``InfillEngine``
(nucleus 0.9, the committed flagship snapshot in bf16, the duration
retries on) with no bound on the decoder's graphs, and records every
decode's key and whether it captured.  The requests: scores of 4, 8, 12 or
16 bars and 1, 2 or 3 tracks (sources of 266-1285 ids, buckets 512, 1024
and 1536), each infilling 1-3 bars of one track.  Closed-loop clients,
each waiting an exponential think time (mean ``THINK_S``) between its
requests, in phases of 1, 2, 4, 8, 16, 4 and 1 clients, so the batch size
ranges over 1..8 as the load rises and falls.

From the recorded keys it reports the distinct keys, the share of decodes
(and of batches' first decodes: a retry re-decodes its batch under the
same key) that found their graph under a least-recently-used bound of 1,
2, 4, 6, 8, 12, 16 and 24 graphs and with none, the captures' ms against
the batches' wall time, and the device memory the graphs hold.

    python scripts/graph_cache_mix.py [--out runs/graph_cache_mix.json]

``--device cpu`` runs the same mix through the twins, for a dry run at a
small ``--max_tgt_len``; its times are the host's, not a card's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from smer_music_generation_tpu_torch.codec.annotate import encode_midi  # noqa: E402
from smer_music_generation_tpu_torch.infer import decode as decode_mod  # noqa: E402
from smer_music_generation_tpu_torch.infer.engine import InfillEngine, change_controls  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_graph as dg  # noqa: E402
from smer_music_generation_tpu_torch.serve.app import MicroBatcher  # noqa: E402
from smer_music_generation_tpu_torch.train.state import (  # noqa: E402
    default_flagship_snapshot,
    load_inference_model,
)
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from smer_music_generation_tpu_torch.vocab import WordVocab  # noqa: E402

PHASES = (1, 2, 4, 8, 16, 4, 1)  # clients of each phase
REQUESTS_A_CLIENT = 4  # in each phase
THINK_S = 0.3  # mean think time between a client's requests
BARS, TRACKS = (4, 8, 12, 16), (1, 2, 3)
LRU_SIZES = (1, 2, 4, 6, 8, 12, 16, 24)


def score_events(vocab, bars: int, tracks: int, seed: int):
    """The events of a seeded score as the plugin's /encode gives them."""
    names = [f"track_{i}" for i in range(tracks)]
    events, controls = encode_midi(cs.make_score(bars=bars, tracks=tracks, seed=seed),
                                   controls={"key": None}, track_names=names)
    controls["bar_track"] = 0
    for name in names:
        controls[f"{name}_c"] = controls[name]
    return change_controls(events, controls, vocab)


def lru_hits(keys, size) -> list:
    """Whether each key of the sequence finds its graph in a cache of
    ``size`` (None: no bound), the least recently used dropped first."""
    kept, hits = OrderedDict(), []
    for k in keys:
        hits.append(k in kept)
        kept.pop(k, None)
        kept[k] = True
        while size is not None and len(kept) > size:
            kept.popitem(last=False)
    return hits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/graph_cache_mix.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max_tgt_len", type=int, default=cs.L)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("graph_cache_mix: no CUDA device", file=sys.stderr)
        return 1

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if on_card else 0

    cfg = ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    model, _ = load_inference_model(cfg, vocab.vocab_size, default_flagship_snapshot(),
                                    torch.bfloat16 if on_card else torch.float32, device=dev)
    engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=args.max_tgt_len, seed=0,
                          fused=True)
    engine.decoder.graphs.size = 1 << 30  # no bound: every distinct key is captured once
    pool = {(b, t): score_events(vocab, b, t, seed=10 * b + t) for b in BARS for t in TRACKS}
    trace, batches = [], []  # (batch, B, S, captured, ms); (B, wall ms)
    real_open, real_run = decode_mod.open_graph, engine.run_batch

    @contextlib.contextmanager
    def spy(graphs, packed, tables, state, aux, span_types, noise, cross_kv, *a, **k):
        before, t0 = graphs.misses, time.perf_counter()
        with real_open(graphs, packed, tables, state, aux, span_types, noise, cross_kv,
                       *a, **k) as graph:
            yield graph
        sync()
        trace.append((len(batches), int(state.shape[1]), int(cross_kv.shape[2]),
                      graphs.misses > before, 1e3 * (time.perf_counter() - t0)))

    def run_batch(reqs, rng=None):
        t0 = time.perf_counter()
        out = real_run(reqs, rng)
        batches.append((len(reqs), 1e3 * (time.perf_counter() - t0)))
        return out

    engine.run_batch = run_batch
    decode_mod.open_graph = spy
    batcher = MicroBatcher(engine, max_batch=8, window_ms=8.0)
    sync()
    mem0 = allocated()
    dg.reset_counts()

    def client(c: int, phase: int):
        rng = np.random.default_rng([args.seed, phase, c])
        for _ in range(REQUESTS_A_CLIENT):
            time.sleep(rng.exponential(THINK_S))
            bars, tracks = int(rng.choice(BARS)), int(rng.choice(TRACKS))
            first = int(rng.integers(0, bars - 2))
            req = engine.prepare(pool[(bars, tracks)], [int(rng.integers(0, tracks))],
                                 list(range(first, first + int(rng.integers(1, 4)))))
            if req is not None:
                seed = int(rng.integers(1 << 30))
                batcher.submit(req, torch.Generator(device=dev).manual_seed(seed))

    t0 = time.perf_counter()
    for phase, n in enumerate(PHASES):
        threads = [threading.Thread(target=client, args=(c, phase)) for c in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    batcher.close()
    sync()
    wall_s = time.perf_counter() - t0
    decode_mod.open_graph = real_open
    graphs = engine.decoder.graphs
    held = allocated() - mem0

    keys = [(B, S) for _, B, S, _, _ in trace]
    first_of_batch = [i for i, row in enumerate(trace) if i == 0 or trace[i - 1][0] != row[0]]
    shares = {}
    for size in LRU_SIZES + (None,):
        hits = lru_hits(keys, size)
        shares["none" if size is None else str(size)] = dict(
            decodes=sum(hits) / len(hits),
            batches=sum(hits[i] for i in first_of_batch) / len(first_of_batch))
    miss_ms = [ms for *_, captured, ms in trace if captured]
    hit_ms = [ms for *_, captured, ms in trace if not captured]
    buffers = {}
    for (B, S, *_), g in graphs.graphs.items():
        nbytes = sum(t.numel() * t.element_size() for t in
                     (g.cache, g.out, g.state, g.aux, g.span_types, g.cross_kv, g.cross_len, g.pos,
                      *(() if g.noise is None else (g.noise,)), *g._work.values()))
        buffers[f"B{B} S{S}"] = nbytes
    report = dict(
        card=torch.cuda.get_device_name(0) if on_card else "cpu",
        requests=sum(b for b, _ in batches),
        batches=len(batches), decodes=len(trace), wall_s=wall_s,
        batch_sizes={str(b): sum(1 for x, _ in batches if x == b) for b in range(1, 9)},
        distinct_keys=sorted(set(keys)), captures=dg.DecodeGraph.captures,
        capture_ms=dg.DecodeGraph.capture_ms, hits=graphs.hits, misses=graphs.misses,
        decode_ms_captured=float(np.mean(miss_ms)) if miss_ms else None,
        decode_ms_found=float(np.mean(hit_ms)) if hit_ms else None,
        batch_wall_ms=float(np.mean([w for _, w in batches])),
        hit_share=shares, graph_buffer_bytes=buffers, device_bytes_held=held,
        retry_keys_same=all(trace[i][1:3] == trace[i - 1][1:3] for i in range(1, len(trace))
                            if trace[i][0] == trace[i - 1][0]),
        trace=trace)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"{report['requests']} requests in {len(batches)} batches ({report['batch_sizes']}), "
          f"{len(trace)} decodes, {wall_s:.1f} s")
    print(f"distinct keys (B, S): {len(report['distinct_keys'])} {report['distinct_keys']}")
    print(f"captures {report['captures']}, capture ms mean "
          f"{np.mean(report['capture_ms'] or [np.nan]):.2f}; a decode that captured "
          f"{report['decode_ms_captured']:.1f} ms against one that found its graph "
          f"{report['decode_ms_found']:.1f} ms; a batch {report['batch_wall_ms']:.1f} ms")
    for size, sh in shares.items():
        print(f"LRU {size:>4}: {sh['decodes']:.3f} of decodes, {sh['batches']:.3f} of batches' "
              f"first decodes find their graph")
    print(f"device memory held by the decoder's {len(graphs.graphs)} graphs: "
          f"{held / 2**20:.1f} MiB (buffers {sum(buffers.values()) / 2**20:.1f} MiB); retries keep the batch's key: "
          f"{report['retry_keys_same']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

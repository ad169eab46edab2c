"""One plugin user: a closed loop of one client calling
``ServingContext.handle_generate`` with the server's micro-batcher on, so a
lone request decodes at one row, sampled from the nucleus.

End to end: ``infill_p95_ms``, the 95th percentile of each request's
latency from its send to its answer, over every request of the window.  (Its
median lies where requests served at once meet those that took a duration
retry, and swings between the two from run to run.)
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import serving
from ..harness import Run, percentile
from ..serving import bench_span, wrap


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.p = run.params

    def sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        from smer_music_generation_tpu_torch.infer.decode import pad_to_bucket
        from smer_music_generation_tpu_torch.serve.app import ServingContext

        run, p = self.run, self.p
        self.vocab, self.model, self.params = serving.load_model(run)
        self.server = ServingContext(self.model, self.vocab, nucleus_p=p["nucleus_p"],
                                     temperature=p["temperature"],
                                     batch_window_ms=p["batch_window_ms"], max_batch=p["max_batch"])
        self.mix = serving.Mix(run, self.server)
        self.trail: Dict[str, List] = {k: [] for k in ("prepared", "submit", "batch", "decode")}
        self.log = serving.DecodeLog()
        wrap(self.server.engine, "prepare", after=self._keep("prepared"))
        wrap(self.server.engine, "run_batch", after=self._keep("batch"))
        wrap(self.server.engine, "_dispatch", after=self._keep("decode"))
        wrap(self.server.batcher, "submit", after=self._keep("submit"))
        # one decode of each source bucket the mix reaches (the retries
        # replay the same graph, and would only make the set-up's length
        # follow the seed), and one request through the whole server
        seen = set()
        for payload in self.mix.warm_payloads():
            req = self.server.engine.prepare(payload["events"], payload["tracks"], payload["bars"])
            bucket = pad_to_bucket(req.src[None]).shape[1]
            if bucket not in seen:
                seen.add(bucket)
                self.server.engine.run_batch([req], self.server.next_rng(), fix_durations=False)
        self.server.handle_generate(self.mix.warm_payloads()[0])
        self.sync()
        for v in self.trail.values():
            v.clear()
        self.log.clear()

    def reseed(self, seed: int) -> None:
        """Another seed's traffic on the same server (for calibration)."""
        self.run.seed = seed
        self.mix = serving.Mix(self.run, self.server)

    def _keep(self, key: str):
        def after(args, out, seconds):
            self.trail[key].append((args, out, seconds))
            if key == "decode":
                self.log.add(args, out)
        return after

    def window(self, tracer) -> None:
        from smer_music_generation_tpu_torch.ops.decode_graph import DecodeGraph

        p = self.p
        self.latencies: List[float] = []
        self.requests: List[Dict] = []
        self.delivered: List = []  # (payload, request, result, its decodes)
        self.failed = 0
        self.log.clear()
        captures = DecodeGraph.captures
        trace_from, trace_n = p["trace_from_request"], p["trace_requests"]
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < self.run.seconds:
            if n == trace_from:
                tracer.start()
            payload = self.mix.next()
            for v in self.trail.values():
                v.clear()
            first = self.log.mark()
            sent = time.perf_counter()
            with bench_span("handle_generate"):
                out = self.server.handle_generate(payload)
            wall = time.perf_counter() - sent
            self.latencies.append(wall)
            n += 1
            if n == trace_from + trace_n or tracer.due():
                tracer.stop()
            if "error" in out or not self.trail["batch"]:
                self.failed += 1
                continue
            req = self.trail["prepared"][-1][1]
            res = self.trail["batch"][-1][1][0]
            if res is None or out["events"] != res.events:
                self.failed += 1
                continue
            self.delivered.append((payload, req, res, (first, self.log.mark())))
            submit = sum(s for *_, s in self.trail["submit"])
            batch = sum(s for *_, s in self.trail["batch"])
            decode = sum(s for *_, s in self.trail["decode"])
            steps = sum(int(o.steps) for _, o, _ in self.trail["decode"])
            self.requests.append(dict(host_s=wall - submit + batch - decode, decode_s=decode,
                                      steps=steps))
        self.sync()
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.latencies)
        self.captures = DecodeGraph.captures - captures

    def end_to_end(self) -> Dict[str, float]:
        ms = 1e3 * np.asarray(self.latencies)
        return {"infill_p95_ms": percentile(ms, 95)}

    def record(self) -> Dict:
        return dict(window_s=self.window_s, requests=self.requests, captures=self.captures,
                    latencies=self.latencies)

    def release(self) -> None:
        """Free the program's state, keeping what the check reads."""
        self.answers = serving.collect(self.run, self.log, self.delivered)
        self.log.close()
        self.server.close()
        del self.server, self.model, self.trail, self.delivered, self.log
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[Dict]:
        out = serving.check(self.run, params=self.params, **self.answers)
        out.append(dict(name="failed_requests", value=float(self.failed), limit=0.0))
        return out

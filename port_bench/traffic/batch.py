"""Offline batch: a closed loop of ``InfillEngine.run_batch`` calls, each
preparing and decoding ``requests_a_call`` requests of the mix (groups of
eight rows, nucleus sampling, the engine's duration retries on).

End to end: ``infill_tokens_per_s``, the tokens of every delivered result
(``len(result.generated)``) over the whole window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import serving
from ..harness import Run
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
        from smer_music_generation_tpu_torch.infer.engine import InfillEngine
        from smer_music_generation_tpu_torch.serve.app import ServingContext

        run, p = self.run, self.p
        self.tracer = None
        self.vocab, self.model, self.params = serving.load_model(run)
        self.encoder = ServingContext(self.model, self.vocab, batch_window_ms=0)
        self.mix = serving.Mix(run, self.encoder)
        self.engine = InfillEngine(self.model, self.vocab, nucleus_p=p["nucleus_p"],
                                   temperature=p["temperature"], max_tgt_len=p["max_tgt_len"],
                                   max_time_fix_attempts=p["max_time_fix_attempts"])
        self.generator = torch.Generator(device=run.device).manual_seed(run.torch_seed(2))
        self.decodes: List[Dict] = []
        self.log = serving.DecodeLog()
        wrap(self.engine, "_dispatch", after=self._decoded)
        # every (rows, source bucket) key the calls can reach, one decode
        # each: the retries replay the same graphs, and would only make the
        # set-up's length follow the seed
        by_bucket: Dict[int, List] = {}
        for payload in self.mix.warm_payloads():
            req = self.prepare(payload)
            by_bucket.setdefault(pad_to_bucket(req.src[None]).shape[1], []).append(payload)
        for payloads in by_bucket.values():
            group = (payloads * p["group_rows"])[: p["group_rows"]]
            self.engine.run_batch([self.prepare(x) for x in group], self.generator,
                                  fix_durations=False)
        self.sync()
        self.decodes.clear()
        self.log.clear()

    def reseed(self, seed: int) -> None:
        """Another seed's traffic on the same server (for calibration)."""
        self.run.seed = seed
        self.mix = serving.Mix(self.run, self.encoder)
        self.generator.manual_seed(self.run.torch_seed(2))

    def _decoded(self, args, out, seconds):
        """Record each decode; the trace slice, started between calls, ends
        after the decode that finds it due, so every decode marked traced
        ran inside it."""
        src, n_spans = args[0], args[2]
        traced = self.tracer is not None and self.tracer.active
        self.log.add(args, out)
        self.decodes.append(dict(
            rows=int(src.shape[0]), steps=int(out.steps), seconds=seconds,
            lengths=[int(x) if n > 0 else 0 for x, n in zip(out.lengths.tolist(), n_spans)],
            cross=[int((row != 0).sum()) for row in src], traced=traced))
        if traced and self.tracer.due():
            self.tracer.stop()

    def prepare(self, payload):
        from smer_music_generation_tpu_torch.infer.engine import change_controls

        bars = payload["bars"]
        controls = dict(payload["controls"], s_bar=min(bars), e_bar=max(bars))
        events = change_controls(payload["events"], controls, self.vocab)
        return self.engine.prepare(events, payload["tracks"], bars)

    def window(self, tracer) -> None:
        p = self.p
        self.tokens = self.attempted = self.failed = self.calls = 0
        self.delivered: List = []  # (payload, request, result, its call's decodes)
        self.log.clear()
        self.tracer = tracer
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.run.seconds:
            if self.calls == p["trace_from_call"]:
                tracer.start()
            payloads = [self.mix.next() for _ in range(p["requests_a_call"])]
            first = self.log.mark()
            with bench_span("call"):
                with bench_span("prepare"):
                    reqs = [self.prepare(x) for x in payloads]
                results = self.engine.run_batch([r for r in reqs if r is not None], self.generator)
            decodes = (first, self.log.mark())
            results = iter(results)
            for payload, req in zip(payloads, reqs):
                self.attempted += 1
                res = next(results) if req is not None else None
                if res is None:
                    self.failed += 1
                    continue
                self.tokens += len(res.generated)
                self.delivered.append((payload, req, res, decodes))
            self.calls += 1
        tracer.stop()
        self.tracer = None
        self.sync()
        self.window_s = time.perf_counter() - t0

    def end_to_end(self) -> Dict[str, float]:
        return {"infill_tokens_per_s": self.tokens / self.window_s}

    def record(self) -> Dict:
        return dict(
            window_s=self.window_s, decodes=self.decodes,
            delivered=[(len(req.src), len(res.generated), res.time_corrections)
                       for _, req, res, _ in self.delivered])

    def release(self) -> None:
        """Free the program's state, keeping what the check reads."""
        self.answers = serving.collect(self.run, self.log, self.delivered)
        self.log.close()
        del self.engine, self.encoder, self.model, self.delivered, self.log
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[Dict]:
        out = serving.check(self.run, params=self.params, **self.answers)
        out.append(dict(name="failed_requests", value=float(self.failed), limit=0.0))
        return out

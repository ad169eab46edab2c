"""HTTP serving layer for the Ableton plugin protocol, on the PyTorch port.

Port of ``smer_music_generation_tpu/serve/app.py``: ``_Pending`` (:37),
``MicroBatcher`` (:50), ``ServingContext`` (:125), ``make_handler`` (:248)
and ``serve`` (:292).  A dependency-free ``http.server`` implementation of
the plugin surface:

* ``POST /encode``    — plugin note dict -> token events + all_controls;
* ``POST /generate``  — events + UI controls + (tracks, bars) -> infilled
  events + regenerated plugin note dicts;
* ``GET  /health``    — model/config status.

The heavy lifting is one decode session per request group
(``infer/engine.py``), on the card through the v3 kernels; the host only
does tokenizer string work.  Where JAX splits a ``PRNGKey`` per request,
the port counts: ``next_rng`` hands out a ``torch.Generator`` on the
model's device seeded from a counter taken under a lock.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import torch

from ..codec.annotate import encode_midi
from ..codec.smer import events_to_midi
from ..infer.engine import InfillEngine, InfillResult, change_controls
from ..vocab import WordVocab
from .protocol import midi2notes, note_midi


class _Pending:
    """One in-flight infill request awaiting its batched decode."""

    __slots__ = ("request", "rng", "done", "result", "error")

    def __init__(self, request, rng: Optional[torch.Generator]):
        self.request = request
        self.rng = rng
        self.done = threading.Event()
        self.result: Optional[InfillResult] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent infill requests into batched device decodes.

    A decode at B=1 leaves most of the kernels' throughput on the table
    (the per-token weight stream is shared across batch rows).  Under
    concurrent plugin traffic the server therefore queues prepared
    requests and drains them in groups: the
    worker takes the first waiting request, keeps collecting until
    ``max_batch`` or ``window_ms`` elapses, and runs ONE
    ``InfillEngine.run_batch`` for the group.  A lone request pays at most
    ``window_ms`` extra latency; concurrent requests gain up to the full
    batched-throughput multiple.  The single consumer thread also
    serializes device access.
    """

    def __init__(self, engine: InfillEngine, max_batch: int = 8,
                 window_ms: float = 8.0):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker once the requests queued before this call are
        decoded."""
        self._queue.put(None)
        self._thread.join(timeout)

    def submit(self, request, rng) -> Optional[InfillResult]:
        """Block until the request's batch is decoded; returns its result."""
        item = _Pending(request, rng)
        self._queue.put(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    # ------------------------------------------------------------------
    def _collect(self) -> List[Optional[_Pending]]:
        batch = [self._queue.get()]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch and batch[-1] is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            stop = batch[-1] is None
            if stop:
                batch.pop()
            if batch:
                self._decode(batch)
            if stop:
                return

    def _decode(self, batch: List[_Pending]) -> None:
        try:
            # one generator for the group is sound: the decoder draws
            # its gumbel noise as ONE (L, B, vpad) array, so every batch
            # row sees distinct noise — identical co-batched requests
            # still sample independently
            results = self.engine.run_batch(
                [b.request for b in batch], batch[0].rng
            )
        except BaseException:
            # isolate the failure: retry each request alone so one bad
            # request cannot fail its co-batched neighbours
            for b in batch:
                try:
                    rng = b.rng if b.rng is not None else batch[0].rng
                    b.result = self.engine.run_batch([b.request], rng)[0]
                except BaseException as exc:
                    b.error = exc
                b.done.set()
            return
        for b, r in zip(batch, results):
            b.result = r
            b.done.set()


class ServingContext:
    """Model + vocab + engine shared across requests.

    ``batch_window_ms > 0`` (default) coalesces concurrent ``/generate``
    requests through :class:`MicroBatcher`; 0 decodes each request
    individually.
    """

    def __init__(self, model, vocab: WordVocab, nucleus_p: float = 0.9,
                 temperature: float = 1.0, batch_window_ms: float = 8.0,
                 max_batch: int = 8, mesh=None, draft_k: int = 0):
        """``draft_k > 0`` decodes a request that is alone in its group by
        speculative decode; a group of several goes through the batched
        loop, as in JAX.  ``mesh`` (``parallel.mesh.make_mesh``) places the
        model on every dp device once and shards each batch's rows over
        them (``InfillEngine``)."""
        self.vocab = vocab
        self.device = model.device
        self.engine = InfillEngine(
            model, vocab, nucleus_p=nucleus_p, temperature=temperature,
            mesh=mesh, draft_k=draft_k,
        )
        self.batcher = (
            MicroBatcher(self.engine, max_batch=max_batch,
                         window_ms=batch_window_ms)
            if batch_window_ms > 0
            else None
        )
        self._requests = 0
        self._lock = threading.Lock()

    def next_rng(self) -> torch.Generator:
        """A generator of its own for each request, seeded 1, 2, 3, ..."""
        with self._lock:
            self._requests += 1
            seed = self._requests
        return torch.Generator(device=self.device).manual_seed(seed)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    # ------------------------------------------------------------------
    def handle_encode(self, payload: Dict) -> Dict:
        controls = payload.get("controls", {})
        start_bar = controls.get("start_bar", 1)
        notes = payload["notes"]
        score = note_midi(notes, start_bar)
        if score is None:
            return {"error": "no playable tracks"}
        track_names = [
            f"track_{i}" for i in range(len(score.instruments))
        ]
        # note_midi keeps only present tracks with program > 0 (reference
        # encode.py:110-120), so sparse plugin track sets are renumbered
        # densely; everything downstream (/generate's `tracks` indices,
        # lock-flag keys) uses THIS namespace.  Return the mapping so the
        # plugin can translate its own track numbers.
        surviving = [
            n for n in range(5)
            if f"track_{n}" in notes and notes.get(f"track_{n}_program", 0) > 0
        ]
        track_map = {
            f"track_{plugin_n}": track_names[i]
            for i, plugin_n in enumerate(surviving)
        }
        result = encode_midi(
            score,
            controls={"key": controls.get("key")},
            infill=False,
            track_names=track_names,
        )
        if result is None:
            return {"error": "encode failed"}
        events, all_controls = result
        if self.vocab.mode == 1:
            # REMI serving: the codec tokenizes SMER; convert the annotated
            # stream for a mode-1 vocab (smer_to_remi keeps controls)
            from ..codec.remi import smer_to_remi

            events = smer_to_remi(events)
        return {"events": events, "controls": all_controls, "track_map": track_map}

    def handle_generate(self, payload: Dict) -> Dict:
        events = list(payload["events"])
        controls = payload["controls"]
        tracks = payload.get("tracks", [0])
        bars = payload.get("bars", [])
        # Window-bound conventions follow the reference exactly:
        # change_controls compares s_bar/e_bar against 0-based window bar
        # indices (generation.py:817) while midi2notes subtracts start_bar
        # (absolute plugin bars, encode.py:1322-1324) — the plugin supplies
        # values satisfying its own calibration.  When a caller omits the
        # bounds, derive them per consumer from the requested bars (the
        # reference KeyErrors instead): relative here, absolute at the
        # midi2notes call below.
        cc_controls = controls
        if bars and ("s_bar" not in controls or "e_bar" not in controls):
            cc_controls = dict(controls)
            cc_controls.setdefault("s_bar", min(bars))
            cc_controls.setdefault("e_bar", max(bars))
        events = change_controls(events, cc_controls, self.vocab)
        if self.batcher is not None:
            prepared = self.engine.prepare(events, tracks, bars)
            result = (
                self.batcher.submit(prepared, self.next_rng())
                if prepared is not None
                else None
            )
        else:
            result = self.engine(events, tracks, bars, self.next_rng())
        if result is None:
            return {"error": "generation failed"}
        out: Dict = {"events": result.events, "decode_steps": result.decode_steps}
        tempo = float(payload.get("tempo", 100.0))
        if self.vocab.mode == 1:
            from ..codec.remi import remi_to_midi

            partial = remi_to_midi(result.events, tempo)
        else:
            partial = events_to_midi(result.events, tempo)
        if partial is not None and "start_bar" in controls:
            track_names = [f"track_{i}" for i in range(len(partial.instruments))]
            # midi2notes expects ABSOLUTE plugin bar numbers; a derived
            # min..max window also covers intermediate bars of a gapped
            # request (their note dicts are encode-round-trip 16th-grid
            # copies — the plugin UI only fills contiguous ranges)
            window = dict(controls)
            if bars:
                window.setdefault("s_bar", window["start_bar"] + min(bars))
                window.setdefault("e_bar", window["start_bar"] + max(bars))
            out["notes"] = midi2notes(partial, tempo, track_names, window)
        return out


def make_handler(ctx: ServingContext):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "vocab_size": ctx.vocab.vocab_size})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (json.JSONDecodeError, ValueError):
                # ValueError also covers a non-numeric Content-Length:
                # answer 400 instead of dropping the connection
                self._send(400, {"error": "bad json"})
                return
            try:
                if self.path == "/encode":
                    self._send(200, ctx.handle_encode(payload))
                elif self.path == "/generate":
                    self._send(200, ctx.handle_generate(payload))
                else:
                    self._send(404, {"error": "not found"})
            except (KeyError, IndexError, TypeError, ValueError) as e:
                # malformed/incomplete payloads are client errors
                self._send(400, {"error": f"bad request: {type(e).__name__}: {e}"})
            except Exception as e:  # serving robustness: report, don't die
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(ctx: ServingContext, host: str = "0.0.0.0", port: int = 5000) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(ctx))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server

"""Host time a request spends in the server and the engine: the request's
wall time outside the micro-batcher's ``submit``, plus its share of
``run_batch``'s wall time outside the decoder (the mean over the window;
queue wait and decode left out)."""

LAYER, UNIT, SOURCE, MOVES = "engine", "ms", "host_clock", "infill_p95_ms"


def read(rec):
    reqs = rec.get("requests") or []
    return 1e3 * sum(r["host_s"] for r in reqs) / len(reqs) if reqs else None

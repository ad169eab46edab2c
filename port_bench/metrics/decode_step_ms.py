"""The decoder's wall time (its encode included) over the decode steps it
ran, over every request of the window."""

LAYER, UNIT, SOURCE, MOVES = "decode loop", "ms", "host_clock", "infill_p95_ms"


def read(rec):
    reqs = rec.get("requests") or []
    steps = sum(r["steps"] for r in reqs)
    return 1e3 * sum(r["decode_s"] for r in reqs) / steps if steps else None

"""CUDA graphs the decoder captured inside the window (set-up captures
every key the traffic reaches)."""

LAYER, UNIT, SOURCE, MOVES = "decode graph", "count", "program_counter", "infill_p95_ms"


def read(rec):
    return rec.get("captures")

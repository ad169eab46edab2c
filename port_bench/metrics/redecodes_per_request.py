"""Re-decodes a delivered request took before its spans closed (the
engine's duration retries), the mean over the window."""

LAYER, UNIT, SOURCE, MOVES = "engine", "count", "program_counter", "infill_tokens_per_s"


def read(rec):
    done = rec.get("delivered") or []
    return sum(c for *_, c in done) / len(done) if done else None

"""Live row-steps over the rows times the steps of every decode of the
window: the share of the decode loop's row-steps that produced a token."""

LAYER, UNIT, SOURCE, MOVES = "decode loop", "%", "program_counter", "infill_tokens_per_s"


def read(rec):
    decodes = rec.get("decodes") or []
    slots = sum(d["rows"] * d["steps"] for d in decodes)
    return 100.0 * sum(sum(d["lengths"]) for d in decodes) / slots if slots else None

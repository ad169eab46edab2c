"""``rowvec_kernel``'s least time over its device time in the traced slice:
each decode step of the slice streams the decoder's weights once for its
rows (``roofline.rowvec_token``)."""

from port_bench import harness, roofline

LAYER, UNIT, SOURCE, MOVES = "decode kernels", "%", "device_trace", "infill_tokens_per_s"


def read(rec):
    trace = rec.get("trace")
    traced = [d for d in rec.get("decodes") or [] if d["traced"]]
    if not trace or not traced:
        return None
    spent = harness.kernel_seconds(trace, "rowvec_kernel")
    least = sum(d["steps"] * roofline.bound_s(*roofline.rowvec_token(rec["config"], d["rows"]))
                for d in traced)
    return 100.0 * least / spent if spent > 0 else None

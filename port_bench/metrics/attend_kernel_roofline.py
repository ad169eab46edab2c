"""``attend_kernel``'s least time over its device time in the traced slice:
each live row reads its self cache up to its position and its cross cache
once a step (``roofline.attend_decode``)."""

from port_bench import harness, roofline

LAYER, UNIT, SOURCE, MOVES = "decode kernels", "%", "device_trace", "infill_tokens_per_s"


def read(rec):
    trace = rec.get("trace")
    traced = [d for d in rec.get("decodes") or [] if d["traced"]]
    if not trace or not traced:
        return None
    spent = harness.kernel_seconds(trace, "attend_kernel")
    least = sum(roofline.bound_s(*roofline.attend_decode(rec["config"], d["lengths"], d["cross"]))
                for d in traced)
    return 100.0 * least / spent if spent > 0 else None

"""Device operations (kernels, copies, sets) a train step launches, in the
traced slice."""

from port_bench import harness

LAYER, UNIT, SOURCE, MOVES = "train step", "count", "device_trace", "train_tokens_per_s"


def read(rec):
    trace, traced = rec.get("trace"), rec.get("traced") or []
    if not trace or not traced:
        return None
    return harness.kernel_launches(trace) / len(traced)

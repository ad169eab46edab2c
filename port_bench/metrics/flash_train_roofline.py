"""The flash training kernels' (forward, dq, dk/dv) least time, from the
operations the attention needs (``roofline.flash_train_step``) at the bf16
peak, over their device time in the traced slice."""

from port_bench import harness, roofline

LAYER, UNIT, SOURCE, MOVES = "flash-train kernels", "%", "device_trace", "train_tokens_per_s"


def read(rec):
    trace, traced = rec.get("trace"), rec.get("traced") or []
    if not trace or not traced:
        return None
    spent = harness.kernel_seconds(trace, "flash_train_")
    flops = sum(roofline.flash_train_step(rec["config"], *rec["lens"][k]) for k in traced)
    return 100.0 * flops / roofline.BF16_FLOPS / spent if spent > 0 else None

"""Model operations of the window's train steps (forward and backward over
each row's real tokens, ``roofline.train_flops``) over the window, against
the chip's bf16 peak (989 TFLOP/s)."""

from port_bench import roofline

LAYER, UNIT, SOURCE, MOVES = "train step", "%", "host_clock", "train_tokens_per_s"


def read(rec):
    order = rec.get("order") or []
    if not order:
        return None
    flops = sum(roofline.train_flops(rec["config"], *rec["lens"][k]) for k in order)
    return 100.0 * flops / rec["window_s"] / roofline.BF16_FLOPS

"""Model operations of the delivered requests (each source's encode and
its delivered tokens' decode) over the window, against the chip's bf16
peak (989 TFLOP/s)."""

from port_bench import roofline

LAYER, UNIT, SOURCE, MOVES = "serving step", "%", "host_clock", "infill_tokens_per_s"


def read(rec):
    done = rec.get("delivered") or []
    if not done:
        return None
    cfg = rec["config"]
    flops = sum(roofline.encode_flops(cfg, s) + roofline.decode_flops(cfg, n, s) for s, n, _ in done)
    return 100.0 * flops / rec["window_s"] / roofline.BF16_FLOPS

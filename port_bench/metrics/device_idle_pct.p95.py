"""The share of the traced slice in which no operation ran on the device."""

from port_bench.harness import idle_pct as read  # noqa: F401

LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "infill_p95_ms"

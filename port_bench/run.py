"""Run one cell of the PyTorch/CUDA port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, the kernels' build on a checkout's first run, warming
every shape the cell's traffic uses) is timed from the start of this
process as ``setup_s``; then the cell's traffic runs for ``--seconds``
(closed loops: to the end of the call or step under way).  With
``--trace 1`` a bounded slice of that window runs under ``torch.profiler``
and the per-layer metrics are reported in place of the end-to-end ones.
Once the window has closed and the program's state is freed, the plain
reference (``port_bench/reference/``) checks what the timed path produced;
each number compared is printed beside its limit as the last lines of
standard error and under ``comparisons``, the last key of the result, the
JSON object on the last line of standard output.

Exits 3 without a result where the card the cell asks for is missing, and 4
where JAX, flax or the JAX package was loaded.  ``--rehearse`` runs the
cell end to end on the CPU at a small size (``harness.REHEARSAL``), through the
program's CPU paths, and reports no device metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    from port_bench import harness

    cell = harness.workload(args.workload)
    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), args.rehearse,
                      cell=cell, config=harness.config(cell["config"]))
    import torch

    if args.rehearse:
        run.cell, run.config = harness.rehearsal(run.cell, run.config)
        run.device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        run.device = torch.device("cuda", 0)
    return report(run, harness, torch)


def warm_profiler(torch) -> None:
    """A process's first profiler session pays the device tracer's start;
    one short session in set-up keeps it out of the traced slice."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device="cuda").sum().item()


def report(run, harness, torch) -> int:
    bench = harness.manifest()
    e2e, layer = harness.cell_metrics(run.name, bench)
    driver = harness.traffic_module(run.cell["traffic"]).Driver(run)
    on_card = run.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver.setup()
    if run.trace and on_card:
        warm_profiler(torch)
    sync()
    setup_s = time.perf_counter() - T_START
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = harness.Tracer(run.trace and on_card, sync, run.params.get("trace_seconds", float("inf")))
    driver.window(tracer)
    tracer.stop()
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    values = dict(driver.end_to_end(), setup_s=setup_s)
    rec = dict(driver.record(), trace=tracer.reduce(), config=run.config, params=run.params)
    driver.release()
    comparisons = driver.check()
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4

    correct = all(harness.finite(c["value"]) and c["value"] <= c["limit"] for c in comparisons)
    metrics = {}
    for m in (layer if run.trace else e2e) if on_card else ():  # a rehearsal reports none
        value = harness.metric_module(m["name"]).read(rec) if run.trace else values[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": run.cell["chips"] if on_card else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics, "device": device}
    trace = rec["trace"]
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        ops = sorted(((k, v[0]) for k, v in trace["kernels"].items()), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops[:10]],
                               "idle_gaps": [[k, v] for k, v in trace["gaps"][:10]]}
    result["comparisons"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                             for c in comparisons}
    for c in comparisons:
        extra = "".join(f" {k} {v}" for k, v in c.items() if k not in ("name", "value", "limit"))
        print(f"{c['name']} {c['value']!r} limit {c['limit']!r}{extra}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's correctness limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1-12 --control 1-3 \
        [--seconds 8] [--out chiprun_out/calibrate_<cell>.json]

For each seed, the numbers the cell's check compares, as sound runs of the
program give them (the lower readings), and on the ``--control`` seeds the
same numbers read off the control: the plain reference computed in float8
(e4m3, one scale a tensor) in the program's place, the precision below the
configuration's bf16.  A serving cell sets up its server once and runs a
short window of its own traffic a seed (``--seconds``; long enough for the
sample's tokens), then reads, at the same positions of the same sampled
requests with the same noise, the gap of the control's draw.  A
training cell sets up and drives its first three steps a seed; the control
follows them in float8, and a planted fault follows them on the first half
of each batch (half the batch left out, the mean taken over the rest).  A
step that returns its state unchanged reads 1 on ``change_gap`` by the
measure itself.  Nothing of this runs in the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def serving_readings(run, driver, seed_list, controls, seconds, harness):
    import numpy as np

    from port_bench import serving
    from port_bench.reference.grammar import Vocab
    from port_bench.reference.model import Reference
    from port_bench.reference.serve_check import sample_gaps

    vocab = Vocab(run.config["vocab_mode"])
    params = serving.reference_params(run, driver.params)
    ref = Reference(params, run.config)
    ctl = Reference(params, run.config, quant="fp8")
    p, slack = run.params, run.cell["limits"]["nucleus_slack"]
    rows = []
    for seed in seed_list:
        driver.reseed(seed)
        run.seconds = seconds
        driver.window(harness.Tracer(False, driver.sync))
        answers = serving.collect(run, driver.log, driver.delivered)
        found = [c for c in serving.check(run, params=driver.params, **answers)]
        row = dict(seed=seed, failed=driver.failed, requests=len(answers["every"]),
                   **{c["name"]: c["value"] for c in found})
        row["outside"] = found[0]["outside"]
        row["tokens"] = found[0]["tokens"]
        if seed in controls:
            c, outside = sample_gaps(ref, vocab, answers["picked"], run.device, p["span_cap"],
                                     p["nucleus_p"], p["temperature"], slack, run.cell["limits"]["tie"],
                                     control=ctl)
            finite = c[np.isfinite(c)]
            row.update(control_sample_gap=float(c.max()), control_finite=float(finite.max()),
                       control_outside_slack=int((~np.isfinite(c)).sum()),
                       control_outside=outside, control_parted=int((c > 0).sum()))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def training_readings(run, seed_list, controls, harness):
    from port_bench.reference import train_check

    rows = []
    for seed in seed_list:
        run.seed = seed
        driver = harness.traffic_module("train").Driver(run)
        driver.setup()
        driver.release()
        ref = driver.reference()
        row = dict(seed=seed, **train_check.readings(driver.losses, driver.first, driver.change,
                                                     *ref, detail=True))
        if seed in controls:
            for tag, kw in (("control", dict(quant="fp8")),
                            ("half_batch", dict(rows=slice(0, run.params["rows"] // 2)))):
                got = driver.reference(**kw)
                for k, v in train_check.readings(*got, *ref, detail=True).items():
                    row[f"{tag}_{k}"] = v
        rows.append(row)
        print(json.dumps(row), flush=True)
        del driver
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control", default="1-3")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    cell = harness.workload(args.workload)
    run = harness.Run(args.workload, 0, args.seconds, False, args.rehearse, cell=cell,
                      config=harness.config(cell["config"]))
    if args.rehearse:
        run.cell, run.config = harness.rehearsal(run.cell, run.config)
        run.device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    else:
        run.device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    seed_list, controls = seeds(args.seeds), set(seeds(args.control))
    if cell["traffic"] == "train":
        rows = training_readings(run, seed_list, controls, harness)
    else:
        driver = harness.traffic_module(cell["traffic"]).Driver(run)
        driver.setup()
        rows = serving_readings(run, driver, seed_list, controls, args.seconds, harness)
    card = torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu"
    report = dict(workload=args.workload, card=card, seconds=time.perf_counter() - t0, rows=rows)
    keys = sorted({k for r in rows for k in r} - {"seed", "tokens", "requests"})
    for k in keys:
        vals = [r[k] for r in rows if isinstance(r.get(k), (int, float))]
        if vals:
            report[f"max_{k}"], report[f"min_{k}"] = max(vals), min(vals)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

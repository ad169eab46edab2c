"""What every cell of the port's benchmark shares: finding a cell's files by
name, the run's seeded streams, the bounded trace slice and its reduction,
the per-layer metric readers, the check for JAX in the process, and the
result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>.json``),
its traffic driver (``traffic/<traffic>.py``), the driver's parameters and
the limits of its correctness comparison.  ``BENCHMARK.json`` at the root of
the checkout names the metrics each cell reports; a per-layer metric is
read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smer_music_generation_tpu")

# a small model and short traffic for a CPU rehearsal
REHEARSAL = dict(
    config=dict(d_model=64, nhead=2, num_encoder_layers=1, num_decoder_layers=1, d_ff=128,
                max_seq=2400, dtype="float32"),
    params=dict(requests_a_call=4, group_rows=2, max_tgt_len=400, max_time_fix_attempts=1,
                scores_each=1, bars=[4], tracks=[1, 2], check_tokens=40,
                trace_from_call=0, trace_from_request=0, trace_requests=1,
                rows=2, src_len=128, tgt_len=128, pool=3, warm_steps=0, trace_from_step=0,
                trace_steps=1),
)


def rehearsal(cell: Dict, cfg: Dict):
    """A cell and its configuration cut to the rehearsal's size."""
    params = {k: REHEARSAL["params"].get(k, v) for k, v in cell["params"].items()}
    return dict(cell, params=params), dict(cfg, **REHEARSAL["config"])


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def workload(name: str) -> Dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def traffic_module(name: str):
    return importlib.import_module(f"port_bench.traffic.{name}")


def metric_module(name: str):
    """``metrics/<name>.py``, loaded by path (a name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(cell: str, bench: Dict):
    """(end-to-end entries, per-layer entries) this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    """Modules of JAX, flax or the JAX package in this process, by whole
    top-level name (the port's own name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """One run of one cell: its files, seed and options."""

    name: str
    seed: int
    seconds: float
    trace: bool
    rehearse: bool = False
    cell: Dict = field(default_factory=dict)
    config: Dict = field(default_factory=dict)
    device: object = None

    @property
    def params(self) -> Dict:
        return self.cell["params"]

    def rng(self, *stream: int) -> np.random.Generator:
        """A numpy stream of this seed (any whole number) and ``stream``."""
        return np.random.default_rng([abs(int(self.seed)) % (1 << 64), *stream])

    def torch_seed(self, *stream: int) -> int:
        return int(self.rng(*stream).integers(1 << 62))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linearly interpolated."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Tracer:
    """``torch.profiler`` over one bounded slice of the window (the profiler
    drops records late in long traces): ``start`` and ``stop`` synchronise
    the device, a driver stops the slice at its next boundary once
    ``due()`` (``seconds`` after the start), and ``reduce`` turns the slice
    into device seconds by kernel, the busy and idle time and the longest
    idle gaps by what the host was doing: the innermost host op or
    ``bench.*`` span of the harness covering the gap, on any thread, past
    the CUDA runtime's own calls."""

    def __init__(self, on: bool, sync, seconds: float = float("inf")):
        self.on, self.sync, self.seconds = on, sync, seconds
        self.prof = None
        self.window_s = None
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        if not self.on or self.prof is not None or self.done:
            return
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    def stop(self) -> None:
        if not self.active:
            return
        self.sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done = True

    def reduce(self) -> Optional[Dict]:
        if not self.done:
            return None
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                    device.append(span)
            else:
                host.append(span)
        return reduce_trace(device, host, self.window_s)


RUNTIME_CALLS = ("cuda", "cu", "Activity Buffer")


def short_name(name: str) -> str:
    """A device operation's name without its argument list and namespace."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i][:160].strip()
    return name[:160]


def reduce_trace(device, host, window_s: float) -> Optional[Dict]:
    """Device seconds and launches by name, busy seconds, and idle seconds by
    the host op covering each gap, from (start µs, end µs, name) spans of
    device operations and of host ops."""
    import heapq

    if not device:
        return None
    kernels: Dict[str, List[float]] = {}
    for s, e, name in device:
        k = kernels.setdefault(short_name(name), [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
    intervals = sorted((s, e) for s, e, _ in device)
    merged = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    lo = min([h[0] for h in host] + [merged[0][0]])
    hi = max([h[1] for h in host] + [merged[-1][1]])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps_iv = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    # sweep the gaps' midpoints in order over the host ops sorted by start,
    # keeping the ops that cover the point in a heap by their end
    host = sorted(host)
    active: List = []
    gaps: Dict[str, float] = {}
    i = 0
    for s, e in sorted(gaps_iv, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], -host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        ops = [a for a in active if not a[2].startswith(RUNTIME_CALLS)]
        name = min(ops, key=lambda a: a[0] + a[1])[2] if ops else "(no host op)"
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    return dict(kernels=kernels, busy_s=busy_s, window_s=window_s,
                gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def kernel_seconds(trace: Dict, family: str) -> float:
    return sum(s for name, (s, _) in trace["kernels"].items() if family in name)


def kernel_launches(trace: Dict, family: Optional[str] = None) -> int:
    return sum(n for name, (_, n) in trace["kernels"].items() if family is None or family in name)


def idle_pct(rec: Dict) -> Optional[float]:
    """The share of the traced slice in which no operation ran on the device."""
    trace = rec.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)

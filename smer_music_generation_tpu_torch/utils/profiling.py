"""Tracing and profiling hooks.

Port of ``smer_music_generation_tpu/utils/profiling.py``:

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in Perfetto or chrome://tracing) of
  the wrapped region, the CUDA activity included when a card is present;
* :class:`StepTimer` — wall-clock step timing with p50/p90 summaries (host
  side; the caller synchronises where it wants device time included);
* :func:`device_memory_stats` — per-device memory use from
  ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    def __init__(self, name: str = "step"):
        self.name = name
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        arr = np.asarray(self.durations)
        return {
            f"{self.name}_p50_s": float(np.percentile(arr, 50)),
            f"{self.name}_p90_s": float(np.percentile(arr, 90)),
            f"{self.name}_mean_s": float(arr.mean()),
            f"{self.name}_count": len(arr),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            }
    return out

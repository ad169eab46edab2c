"""On a CUDA card: each cell runs correct at its own size, and its control
(the plain reference in float8 in the program's place) reads past at least
one of the cell's limits.  Each test decides for itself whether a card is
present and skips without one."""

import json
import subprocess
import sys

import pytest

from port_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    need_card()
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          "4242424242", "--seconds", "5", "--trace", "0"], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = last_json(out.stdout)
    assert res["correct"], res["comparisons"]
    assert res["device"]["platform"] == "gpu" and "setup_s" in res["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    need_card()
    out = subprocess.run([sys.executable, "port_bench/calibrate.py", "--workload", cell, "--seeds",
                          "77", "--control", "77", "--seconds", "8"], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    report = last_json(out.stdout)
    limits = harness.workload(cell)["limits"]
    assert any(report.get(f"min_control_{k}", 0.0) > v for k, v in limits.items()), report

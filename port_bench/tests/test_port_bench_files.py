"""Every cell, configuration, traffic driver and per-layer metric of
``BENCHMARK.json`` is a file of its own, found by name, and the manifest
keeps to the contract's shapes."""

import json
import re

import pytest

from port_bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][1] == "port_bench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.workload(cell)
    assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert len(entry["why"]) <= 200
    cfg = harness.config(spec["config"])
    assert cfg["name"] == spec["config"]
    assert hasattr(harness.traffic_module(spec["traffic"]), "Driver")
    e2e, layer = harness.cell_metrics(cell, BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert entry["reduced"] == []
    assert (harness.ROOT / cfg["reference"]).is_file()


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_match_manifest(entry):
    module = harness.metric_module(entry["name"])
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert module.read({}) is None  # nothing to read: nothing reported
    if entry["name"].endswith("_roofline"):
        assert entry["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_trace_reduction_by_hand():
    # two kernels with a 10 µs gap inside a host span, 5 µs idle at the end
    device = [(0.0, 10.0, "k1"), (5.0, 20.0, "k2"), (30.0, 40.0, "k1")]
    host = [(0.0, 45.0, "aten::mm"), (18.0, 32.0, "bench.prepare"), (19.0, 21.0, "cudaLaunchKernel")]
    got = harness.reduce_trace(device, host, 45e-6)
    assert got["kernels"] == {"k1": [pytest.approx(20e-6), 2], "k2": [pytest.approx(15e-6), 1]}
    assert got["busy_s"] == pytest.approx(30e-6)
    assert dict(got["gaps"]) == {"bench.prepare": pytest.approx(10e-6), "aten::mm": pytest.approx(5e-6)}
    assert harness.reduce_trace([], host, 1.0) is None


def test_short_kernel_names():
    assert harness.short_name("void (anonymous namespace)::rowvec_kernel<__nv_bfloat16, true>(float const*, int)") \
        == "rowvec_kernel<__nv_bfloat16, true>"
    assert harness.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"

"""BENCHMARK.json against the contract, and every name resolved to its file."""

import json
import os
import re

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"]) and entry["name"] not in names
            names.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    metrics = set()
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            base = {"name", "unit", "better", "source"} | (
                {"bound"} if group == "end_to_end" else {"layer", "moves"})
            assert base <= set(m) <= base | {"workloads"}, m
            assert NAME.match(m["name"]) and m["name"] not in metrics
            metrics.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert set(m.get("workloads", [])) <= set(CELLS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"perfbench/configs/{w['config']}.json"
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert all(k in cfg for k in entry["reduced"])
    traffic = spec.traffic(w["traffic"])
    assert hasattr(spec.driver(traffic["driver"]), "Driver")
    assert spec.limits(cell)
    assert w["chips"] == 1
    e2e = [m["name"] for m in spec.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_resolves(metric):
    assert callable(spec.reader(metric))


def test_every_config_used_and_layers_named_alike():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_result_line_schema():
    from perfbench.run import result_line

    out = {"checks": {"x": {"value": 0.1, "limit": 1.0}}, "correct": True, "attempted": 3,
           "failed": 0, "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
           "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                      "memory_peak_bytes": 1}, "_notes": {}}
    line = json.loads(result_line(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]

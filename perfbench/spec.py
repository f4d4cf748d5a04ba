"""Name resolution: every name in ``BENCHMARK.json`` to its file.

- a workload's configuration: ``perfbench/configs/<config>.json``;
- its traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names the general generator in ``perfbench/drivers/<driver>.py`` that reads
  it;
- the limits of its ``correct`` check: ``perfbench/limits/<workload>.json``;
- a per-layer metric: ``perfbench/metrics/<metric>.py``, a reader with
  ``read(readings) -> float | None``.

A later change adds a configuration, a mix or a metric by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload_name: str) -> Dict[str, float]:
    return load_json(os.path.join(HERE, "limits", f"{workload_name}.json"))


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(metric: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric with ``workloads`` is read in those cells; one
    without, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def end_to_end(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    e2e = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if _applies(m, cell, e2e)]

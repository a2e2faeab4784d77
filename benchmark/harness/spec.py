"""BENCHMARK.json, and every part of a cell found by its name.

- a configuration: benchmark/configs/<config>.json
- a traffic mix:   benchmark/traffic/<traffic>.json
- a metric:        benchmark/metrics/<name>.py, or for a family of
                   metrics split by cell (`device.idle.graph`) the file of
                   the longest dotted prefix that exists (`device.idle.py`)
- a check:         benchmark/reference/checks/<check>.py, named by the mix
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def list_cells(root: str) -> list:
    return [w["name"] for w in load_spec(root)["workloads"]]


def _json(root: str, sub: str, name: str) -> dict:
    path = os.path.join(root, "benchmark", sub, f"{name}.json")
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, root: str, name: str):
        spec = load_spec(root)
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(by_name)})")
        self.root = root
        self.spec = spec
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = _json(root, "configs", self.workload["config"])
        self.traffic = _json(root, "traffic", self.workload["traffic"])

    def _listed(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self._listed(m)]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if m["moves"] in e2e and self._listed(m)]


def _load_file(path: str, modname: str):
    sp = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of metric `name`: metrics/<name>.py, or the file
    of its longest dotted prefix."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        path = os.path.join(bench_dir, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _load_file(path, "bench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{os.path.join(bench_dir, 'metrics')}")


def check_module(name: str, bench_dir: str = BENCH_DIR):
    path = os.path.join(bench_dir, "reference", "checks", f"{name}.py")
    return _load_file(path, "bench_check_" + name)

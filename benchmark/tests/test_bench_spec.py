"""BENCHMARK.json against the contract's shape, every part of a cell
found by name from files of its own, and no jax or mccortex_tpu in what
the benchmark imports."""

import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_shape():
    d = spec.load_spec(ROOT)
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"]
    assert 1 <= d["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10
    cfgs = {c["name"]: c for c in d["configs"]}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith("benchmark/") and \
            os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(r) for r in c["reduced"])
    names = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4) and _line(w["why"])
        names.add(w["name"])
    assert {w["config"] for w in d["workloads"]} == set(cfgs)
    e2e = {}
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
    allm = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(allm) == len(set(allm))
    for w in names:
        cell = spec.Cell(ROOT, w)
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()


def test_every_metric_has_a_reader():
    d = spec.load_spec(ROOT)
    for m in d["end_to_end"] + d["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read), m["name"]
    for w in d["workloads"]:
        cell = spec.Cell(ROOT, w["name"])
        assert callable(spec.check_module(cell.traffic["check"]).check)


def test_a_cell_added_by_files_alone_is_listed(tmp_path):
    """A later change adds a configuration, a mix and a cell by adding
    files and entries; the harness finds them by name."""
    shutil.copytree(os.path.join(ROOT, "benchmark", "configs"),
                    tmp_path / "benchmark" / "configs")
    shutil.copytree(os.path.join(ROOT, "benchmark", "traffic"),
                    tmp_path / "benchmark" / "traffic")
    d = spec.load_spec(ROOT)
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "ecoli_k31.json")))
    cfg["name"] = "dummy_k31"
    json.dump(cfg, open(tmp_path / "benchmark" / "configs" /
                        "dummy_k31.json", "w"))
    mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                      "links.json")))
    mix["inputs"][1]["chunk_reads"] = 65536
    json.dump(mix, open(tmp_path / "benchmark" / "traffic" /
                        "links_big.json", "w"))
    d["workloads"].append({"name": "dummy_k31.links_big",
                           "config": "dummy_k31", "traffic": "links_big",
                           "chips": 1, "why": "a cell added by files"})
    json.dump(d, open(tmp_path / "BENCHMARK.json", "w"))
    assert "dummy_k31.links_big" in spec.list_cells(str(tmp_path))
    cell = spec.Cell(str(tmp_path), "dummy_k31.links_big")
    assert cell.config["name"] == "dummy_k31"
    assert cell.traffic["inputs"][1]["chunk_reads"] == 65536
    assert [m["name"] for m in cell.end_to_end()] == ["setup_s"]


def test_family_reader_found_by_prefix():
    assert spec.metric_reader("device.idle.graph") is not None
    assert spec.metric_reader("device.idle.some_later_cell").read


def test_no_jax_and_no_jax_package_loaded():
    """Import the harness, every reader, every check and the reference in
    a fresh process; no loaded module's top-level name may be jax or
    mccortex_tpu (compared whole: mccortex_tpu_torch passes)."""
    code = """
import sys
sys.path.insert(0, %r)
from benchmark.harness import runner, spec, driver, profile, readers
from benchmark.reference import compare, dbg, links
from benchmark.tools import control
from benchmark.data import synth
import mccortex_tpu_torch.cli.main
d = spec.load_spec(%r)
for m in d["end_to_end"] + d["per_layer"]:
    spec.metric_reader(m["name"])
for c in ("graph", "links"):
    spec.check_module(c)
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
""" % (ROOT, ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    tops = set(p.stdout.split())
    assert "mccortex_tpu_torch" in tops and "benchmark" in tops
    for bad in ("jax", "jaxlib", "flax", "mccortex_tpu"):
        assert bad not in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark.harness import runner
    monkeypatch.setitem(sys.modules, "mccortex_tpu_torch_x", sys)
    assert "mccortex_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in runner.forbidden_modules()

"""Each cell's job at a tiny size through the harness on the CPU: the
result line's keys, the metrics, and `correct` true on a sound program."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, SEED

from benchmark.harness import runner, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["ecoli_k31.graph", "chr22dip_k31.links"])
def test_cell_on_cpu(tiny_root, cell, trace):
    result, rows = runner.run_cell(tiny_root, cell, SEED, 0.5, bool(trace),
                                   device="cpu")
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(v == 0 and lim == 0 for _, v, lim in rows)
    c = spec.Cell(tiny_root, cell)
    want = {m["name"] for m in (c.per_layer() if trace else c.end_to_end())}
    got = set(result["metrics"])
    # the device's metrics read nothing on the CPU and are left out
    assert got <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert got and all(not n.startswith("device.") for n in got)
    else:
        assert got == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_run_without_card_prints_no_result():
    """On a machine without a card the command fails and prints nothing
    on its standard output."""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                     "run.py"),
                        "--workload", "ecoli_k31.graph", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_bare_checkout_fails(tmp_path):
    """With only BENCHMARK.json and benchmark/ (no program), a run exits
    non-zero and prints no result."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.harness import runner; "
            "runner.run_cell(%r, 'ecoli_k31.graph', 1, 0.1, False, "
            "device='cpu')" % (str(tmp_path), str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
    assert "mccortex_tpu_torch" in p.stderr


@pytest.mark.parametrize("cell", ["ecoli_k31.graph", "chr22dip_k31.links"])
def test_no_cache_of_the_port_hits_across_jobs(tiny_root, cell, monkeypatch):
    """Every job of a window runs the same spans as the first: a cache of
    the port that hit across jobs (the lookup tables, the adjacency, the
    unitig views, all keyed on tensor identity) would drop its span
    (`table`, `adjacency`, ...) from the later jobs."""
    jobs = []
    orig = runner.Run.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        jobs.append(self)
    monkeypatch.setattr(runner.Run, "__init__", init)
    runner.run_cell(tiny_root, cell, SEED + 1, 3.0, False, device="cpu")
    run = jobs[0]
    assert len(run.jobs) >= 2
    first = [sorted(s.spans) for s in run.warmup.steps]
    for job in run.jobs:
        assert [sorted(s.spans) for s in job.steps] == first

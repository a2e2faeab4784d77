"""The cells `kpneu_k61.graph_wide` and `ecoli_k31.thread_plain` at a tiny
size through the harness on the CPU; a planted fault in the plain
threading comes out not correct (the k=61 graph's fault is in
test_bench_reference_wide.py), and so does the control of each check;
and the readers of the counters `fold.bytes` and `table.keys` on canned
status lines."""

import json
import types

import pytest
from conftest import SEED

import mccortex_tpu_torch.io.ctp as ctpio
from benchmark.harness import runner, spec
from benchmark.harness.driver import Job, Step

CELLS = ["kpneu_k61.graph_wide", "ecoli_k31.thread_plain"]
NEW = {"kpneu_k61.graph_wide": {"graph.fold_ratio", "graph.table_ns_per_key",
                                "graph.build_s", "graph.table_s"},
       "ecoli_k31.thread_plain": {"thread.read_s", "thread.write_s",
                                  "thread.ctp_format_ratio"}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_on_cpu(tiny_root, cell, trace):
    result, rows = runner.run_cell(tiny_root, cell, SEED, 0.5, bool(trace),
                                   device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert rows and all(v == 0 and lim == 0 for _, v, lim in rows)
    c = spec.Cell(tiny_root, cell)
    want = {m["name"] for m in (c.per_layer() if trace else c.end_to_end())}
    got = set(result["metrics"])
    if trace:
        # the device's metrics read nothing on the CPU
        assert NEW[cell] <= got <= want
    else:
        assert got == want and "setup_s" in got
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def _ctp_hist_altered(monkeypatch):
    orig = ctpio.save_ctp

    def save_ctp(path, g, links, *a, contig_hists=None, **kw):
        hists = [dict(h) for h in contig_hists]
        n = min(hists[0])
        hists[0][n] += 1
        return orig(path, g, links, *a, contig_hists=hists, **kw)
    monkeypatch.setattr(ctpio, "save_ctp", save_ctp)


def test_fault_comes_out_not_correct(tiny_root, monkeypatch):
    _ctp_hist_altered(monkeypatch)
    result, _ = runner.run_cell(tiny_root, "ecoli_k31.thread_plain", SEED,
                                0.1, False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["hist_diff"]["value"] > 0


@pytest.mark.parametrize("cell,number", [("kpneu_k61.graph_wide",
                                          "raw_diff"),
                                         ("ecoli_k31.thread_plain",
                                          "hist_diff")])
def test_control_fails_the_check(tiny_root, cell, number, capsys):
    from benchmark.tools import control_wide
    control_wide.main(["--root", tiny_root, "--workload", cell, "--seeds",
                       str(SEED), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control"][number] > 0


def _run(k, statuses):
    """A window of two timed jobs whose steps print `statuses` (command:
    status text) and carry `table` spans of 0.25 s."""
    steps = [Step([cmd], 1.0, {"table": 0.25} if cmd != "build" else {},
                  text, 0) for cmd, text in statuses.items()]
    jobs = [Job(i, steps, 3.0, 100, 15000, {}) for i in range(2)]
    return types.SimpleNamespace(timed=jobs, done=jobs, config={
        "k": k, "colours": 1})


BUILD = ("[mctx] built 1000 kmers from 4 batches in 0.5s on cpu\n"
         "[mctx] time split: read 0.1s, build 0.5s, write 0.1s; counts: "
         "fold.bytes {}\n")
TABLE = "[mctx] time split: table 0.250s; counts: table.keys {}\n"


@pytest.mark.parametrize("k, fold_bytes, want", [
    (31, 13 * 1000 * 30, 30.0),          # W = 1: 13-byte records
    (61, 21 * 1000 * 45, 45.0),          # W = 2: 21-byte records
])
def test_fold_ratio_on_canned_lines(k, fold_bytes, want):
    run = _run(k, {"build": BUILD.format(fold_bytes)})
    assert spec.metric_reader("graph.fold_ratio").read(
        run, "graph.fold_ratio") == pytest.approx(want)


def test_table_ns_per_key_on_canned_lines():
    run = _run(61, {"clean": TABLE.format(2_000_000),
                    "unitigs": TABLE.format(500_000)})
    # 4 x 0.25 s of `table` over 2 x 2.5M keys
    assert spec.metric_reader("graph.table_ns_per_key").read(
        run, "graph.table_ns_per_key") == pytest.approx(1e9 / 5e6)


@pytest.mark.parametrize("name", ["graph.fold_ratio",
                                  "graph.table_ns_per_key"])
def test_new_readers_without_the_counters_read_nothing(name):
    """A program without the counters (the parent of this change) gives
    no value and no error."""
    run = _run(61, {"build": "[mctx] built 1000 kmers from 4 batches in "
                             "0.5s on cpu\n",
                    "clean": "[mctx] time split: table 0.250s\n",
                    "unitigs": "[mctx] time split: table 0.250s\n"})
    assert spec.metric_reader(name).read(run, name) is None


class _Event:
    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, int(start * 1e9), int(
            (end - start) * 1e9)
        self._t = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_plain_idle_share_with_the_profiled_job_alone():
    """Busy 1.5 s in a profiled job of 10 s: with no unprofiled job the
    share divides by the profiled job's 10 s; with one of 6 s, by that,
    as device.idle does."""
    from benchmark.harness.profile import JOB_MARK, Profile
    events = [_Event(JOB_MARK, False, 0, 10), _Event("k", True, 1, 2),
              _Event("k", True, 5, 5.5)]
    kineto = types.SimpleNamespace(events=lambda: events)
    prof = Profile(types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto)))
    profiled = Job(0, [], 10.0, 100, 15000, {})
    run = types.SimpleNamespace(profile=prof, profiled_job=profiled,
                                done=[profiled])
    name = "device.idle.thread_plain"
    reader = spec.metric_reader(name)
    assert reader.read(run, name) == pytest.approx(85.0)
    run.done = [profiled, Job(1, [], 6.0, 100, 15000, {})]
    assert reader.read(run, name) == pytest.approx(75.0)
    assert reader.read(run, name) == spec.metric_reader(
        "device.idle.graph").read(run, name)

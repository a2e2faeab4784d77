"""The links cell's readers of the port's tracer: on a tiny CPU run of
the cell through the harness, and on a hand-built profile whose walk
ranges, kernels and counters are known."""

import math
import types

import pytest
from conftest import SEED

from benchmark.harness import runner, spec
from benchmark.harness.driver import Job, Step
from benchmark.harness.profile import JOB_MARK, STEP_MARK, Profile

CELL = "chr22dip_k31.links"
READERS = ["thread.walk_steps", "thread.kernels_per_step",
           "thread.walk_busy", "thread.gapfill_host_s",
           "thread.ctp_format_ratio"]
# what the CPU has no device trace for
DEVICE = {"thread.kernels_per_step", "thread.walk_busy"}


def test_readers_on_tiny_cpu_run(tiny_root, monkeypatch):
    runs = []
    orig = runner.Run.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        runs.append(self)
    monkeypatch.setattr(runner.Run, "__init__", init)
    result, _ = runner.run_cell(tiny_root, CELL, SEED + 2, 0.5, True,
                                device="cpu")
    assert result["correct"] is True
    listed = {m["name"] for m in spec.Cell(tiny_root, CELL).per_layer()}
    assert set(READERS) <= listed
    for name in READERS:
        got = result["metrics"].get(name)
        if name in DEVICE:
            assert got is None
        else:
            assert math.isfinite(got["value"]) and got["value"] > 0, name
        value = spec.metric_reader(name).read(runs[0], name)
        assert value is None or math.isfinite(value)
    ratio = result["metrics"]["thread.ctp_format_ratio"]["value"]
    assert ratio >= 1


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


def _profile(walk_ranges):
    """A job of 10 s: kernels at known times, a copy, and host ranges."""
    host = [(JOB_MARK, 0, 10), (STEP_MARK + "thread", 0, 10),
            ("aten::index", 1.5, 1.6)]
    host += [("walk", s, e) for s, e in walk_ranges]
    dev = [("k_before", 0.5, 0.7), ("k_a", 1.2, 1.8), ("k_b", 2.0, 2.4),
           ("Memcpy DtoH (Device -> Pageable)", 2.5, 2.9),
           ("k_c", 2.8, 3.5), ("k_d", 5.5, 5.7), ("k_after", 7, 8)]
    events = ([_Event(n, False, s, e) for n, s, e in host]
              + [_Event(n, True, s, e) for n, s, e in dev])
    kineto = types.SimpleNamespace(events=lambda: events)
    return Profile(types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto)))


def _run(walk_ranges, counts: bool):
    line = "time split: walk 3.400s"
    if counts:
        line += "; counts: walk.steps 8, ctp.kmers_formatted 30, " \
                "ctp.kmers_written 3"
    spans = {"walk": 3.4, "gaps": 0.5, "bridge": 0.25} if counts else \
        {"walk": 3.4}
    step = Step(["thread"], 9.0, spans, f"[mctx] {line}\n", 0)
    profiled = Job(0, [step], 12.0, 100, 10000, {})
    timed = Job(1, [step], 9.0, 100, 10000, {})
    return types.SimpleNamespace(profile=_profile(walk_ranges),
                                 profiled_job=profiled, timed=[timed],
                                 done=[profiled, timed])


@pytest.mark.parametrize("name, want", [
    # kernels starting in [1, 3) and [5, 6): k_a, k_b, k_c, k_d over 8 steps
    ("thread.kernels_per_step", 4 / 8),
    # busy in the ranges: 0.6 + 0.4 + the copy and k_c merged, cut at
    # 3.0 (0.5) + 0.2, over the timed job's 3.4 s of `walk`
    ("thread.walk_busy", 100 * 1.7 / 3.4),
    ("thread.walk_steps", 8),
    ("thread.gapfill_host_s", 0.75),
    ("thread.ctp_format_ratio", 10),
])
def test_readers_on_known_profile(name, want):
    run = _run([(1, 3), (5, 6)], counts=True)
    assert spec.metric_reader(name).read(run, name) == pytest.approx(want)
    # nested or overlapping ranges count once
    run = _run([(1, 3), (1.5, 2.5), (5, 6)], counts=True)
    assert spec.metric_reader(name).read(run, name) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_tracer_read_nothing(name):
    """A program with no spans on the profiler's timeline and no counters
    (the port before its tracer) gives no value and no error."""
    run = _run([], counts=False)
    assert spec.metric_reader(name).read(run, name) is None

"""The port's tracer (mccortex_tpu_torch/utils/timing.py) on the CPU:
span totals and nesting, counters, the `time split:` line, the spans as
FUNCTION-scope host ranges under torch.profiler (none without one), the
counters and spans of a tiny `build` and `thread` through the CLI, and
the counters `fold.bytes` (graph/build.RecordFold) and `table.keys`
(ops/hashidx) against hand-reckoned values."""

import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import build as gbuild
from mccortex_tpu_torch.ops import hashidx
from mccortex_tpu_torch.ops import sorted as sops
from mccortex_tpu_torch.utils import timing

K = 11


@pytest.fixture(autouse=True)
def clean_tracer():
    timing.reset()
    yield
    timing.reset()


def test_span_totals_and_nesting():
    for _ in range(2):
        with timing.span("outer"):
            time.sleep(0.01)
            with timing.span("inner"):
                time.sleep(0.01)
    # a span is entered in SPANS when it first closes
    assert list(timing.SPANS) == ["inner", "outer"]
    assert timing.SPANS["inner"] >= 0.02
    assert timing.SPANS["outer"] >= timing.SPANS["inner"] + 0.02


def test_reset_clears_spans_and_counters():
    spans, counters = timing.SPANS, timing.COUNTERS
    with timing.span("a"):
        timing.count("x", 3)
    timing.count("x")
    assert timing.COUNTERS == {"x": 4} and "a" in timing.SPANS
    timing.reset()
    assert not timing.SPANS and not timing.COUNTERS
    # cleared in place: a reader that holds the mappings sees it
    assert timing.SPANS is spans and timing.COUNTERS is counters


@pytest.mark.parametrize("counts, want", [
    ({}, "read 0.125s, walk 1.500s"),
    ({"walk.steps": 2411, "ctp.kmers_written": 7},
     "read 0.125s, walk 1.500s; counts: walk.steps 2411, "
     "ctp.kmers_written 7"),
])
def test_summary_line(counts, want):
    timing.SPANS.update(read=0.125, walk=1.5)
    for name, n in counts.items():
        timing.count(name, n)
    assert timing.summary() == want


def test_spans_are_function_ranges_under_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            with timing.span("inner"):
                torch.ones(8).sum()
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name() in ("outer", "inner")}
    assert set(evs) == {"outer", "inner"}
    outer, inner = evs["outer"], evs["inner"]
    # scope 0 is FUNCTION; USER_SCOPE (7), which record_function opens,
    # would be mirrored onto the device's timeline
    assert outer.scope() == 0 and inner.scope() == 0
    assert outer.start_ns() <= inner.start_ns()
    assert (inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())
    assert timing.SPANS["outer"] >= timing.SPANS["inner"] > 0


def test_no_range_without_profiler(monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def fast(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    with timing.span("quiet"):
        pass
    assert opened == [] and "quiet" in timing.SPANS
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("traced"):
            pass
    assert opened == ["traced"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 600 bp genome with a 30 bp repeat (forks, so links): its
    error-free reads as FASTA and reads with a substitution each as
    FASTQ (each substitution a gap to fill)."""
    d = tmp_path_factory.mktemp("timing")
    rng = np.random.default_rng(5)

    def dna(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    rep = dna(30)
    genome = dna(200) + rep + dna(150) + rep + dna(190)
    clean = [genome[s:s + 80] for s in range(0, len(genome) - 80 + 1, 7)]
    fa = d / "clean.fa"
    fa.write_text("".join(f">c{i}\n{r}\n" for i, r in enumerate(clean)))
    lines = []
    for i, r in enumerate(clean):
        b = list(r)
        pos = int(rng.integers(20, 60))
        b[pos] = "ACGT"[("ACGT".index(b[pos]) + 1) % 4]
        lines.append(f"@r{i}\n{''.join(b)}\n+\n{'I' * len(b)}\n")
    fq = d / "reads.fq"
    fq.write_text("".join(lines))
    return d, str(fa), str(fq)


def test_build_status_lines_read_its_spans(tiny, capsys):
    d, fa, _ = tiny
    out = str(d / "g.ctx")
    assert port_main(["build", "-k", str(K), "-s", "s0", "--seq", fa, "-f",
                      out, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    spans = dict(timing.SPANS)
    assert set(spans) >= {"read", "build", "write"}
    got = {name: float(m.group(1)) for name, rx in [
        ("read", r"read 1 batches in ([0-9.]+)s \("),
        ("build", r"built \d+ kmers from 1 batches in ([0-9.]+)s on cpu"),
        ("write", r"wrote \d+ kmers x 1 colours to .* in ([0-9.]+)s")]
        for m in [re.search(rx, err)]}
    assert got == {n: round(spans[n], 3) for n in got}


def test_thread_counts_walker_steps_and_ctp_kmers(tiny, capsys):
    d, fa, fq = tiny
    ctx = str(d / "t.ctx")
    assert port_main(["build", "-k", str(K), "-s", "s0", "--seq", fa, "-f",
                      ctx, "--device", "cpu"]) == 0
    assert port_main(["thread", "--seq", fq, "-f", "-o",
                      str(d / "l.ctp.gz"), ctx, "--device", "cpu"]) == 0
    c = dict(timing.COUNTERS)
    assert c["walk.steps"] > 0
    # on the CPU every linked walk runs the host loop
    assert c["walk.fused"] == 0 and c["walk.plain"] > 0
    assert c["ctp.kmers_formatted"] >= c["ctp.kmers_written"] > 0
    assert {"align", "gaps", "walk", "bridge"} <= set(timing.SPANS)
    line = re.findall(r"time split: (.*)", capsys.readouterr().err)[-1]
    # every read through the C++ parser (counters `read.native`,
    # `read.python`); the graph's lookup table, built once (`table.keys`)
    with open(fq) as fh:
        nreads = len(fh.read().splitlines()) // 4
    assert (c["read.native"], c["read.python"]) == (nreads, 0)
    assert c["table.keys"] > 0
    assert line.endswith(f"; counts: read.native {nreads}, read.python 0, "
                         f"table.keys {c['table.keys']}, "
                         f"walk.fused 0, "
                         f"walk.plain {c['walk.plain']}, "
                         f"walk.steps {c['walk.steps']}, "
                         f"ctp.kmers_formatted {c['ctp.kmers_formatted']}, "
                         f"ctp.kmers_written {c['ctp.kmers_written']}")


def _item(values, W, m=gbuild.MIN_LEVEL):
    """Record planes of m records, one colour: the sorted keys `values`
    (each key's last word; the others 0) at the front, sentinels after."""
    keys = sops.sentinel((m,), W)
    keys[:len(values)] = 0
    keys[:len(values), W - 1] = torch.tensor(sorted(values))
    covg = torch.zeros((m, 1), dtype=torch.int32)
    covg[:len(values)] = 1
    edges = torch.zeros((m, 1), dtype=torch.uint8)
    return gbuild._record_planes(keys, covg, edges)


@pytest.mark.parametrize("W", [1, 2])
def test_fold_bytes_of_three_pushes(W):
    """Three items of MIN_LEVEL records: the second push merges the first
    two (2 x MIN_LEVEL records in, their 150 distinct keys out); the
    third waits on the stack until result() merges it with the first
    merge's item, cut back to MIN_LEVEL (2 x MIN_LEVEL in, 220 out).  A
    record is 8W + 5 bytes at one colour."""
    sets = [range(0, 100), range(50, 150), range(120, 220)]
    fold = gbuild.RecordFold(W, 1)
    for vals in sets:
        fold.push(_item(list(vals), W), len(vals))
    assert timing.COUNTERS["fold.bytes"] == (
        2 * gbuild.MIN_LEVEL + 150) * (8 * W + 5)
    planes, n = fold.result()
    assert n == 220
    assert timing.COUNTERS["fold.bytes"] == (
        4 * gbuild.MIN_LEVEL + 150 + 220) * (8 * W + 5)


def test_table_keys_counts_a_table_built_not_a_cache_hit():
    keys = sops.sentinel((64,), 2)
    keys[:40, 0] = 0
    keys[:40, 1] = torch.arange(1, 81, 2)
    hashidx.get_index32_for(keys)
    assert timing.COUNTERS["table.keys"] == 40
    hashidx.get_index32_for(keys)           # the cached table
    assert timing.COUNTERS["table.keys"] == 40
    hashidx.get_index32_for(keys.clone())   # another tensor: built again
    assert timing.COUNTERS["table.keys"] == 80

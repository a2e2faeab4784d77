"""The linked walker's kernel path (links/walk.py `_takes_kernel`,
`_walk_fused`; csrc/walk.cu) on the CPU: which walks the gate hands to the
kernel, the walk counters of a gap-fill batch, and the kernel itself
compiled for the CPU by scripts/cuda_emul (host threads for CUDA threads),
every field of the state against the host loop's.  Torch and numpy only.
"""

import contextlib
import dataclasses
import importlib.util
import os
import types

import pytest
import torch

from mccortex_tpu_torch.align import correct as acorrect
from mccortex_tpu_torch.graph import traverse as T
from mccortex_tpu_torch.links import store as lstore
from mccortex_tpu_torch.links import thread as lthread
from mccortex_tpu_torch.links import walk as lwalk
from mccortex_tpu_torch.ops.kernels import _build
from mccortex_tpu_torch.utils import timing

import walk_cases as wc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gap_filler_walk(device):
    """A _Walk with the options align/correct.correct_batch gives."""
    return lwalk._Walk(
        g=types.SimpleNamespace(device=torch.device(device)), links=None,
        uedges=None, colour=0, ctpcol=0, edge_colour=0, missing_check=False,
        adj=torch.zeros(8, dtype=torch.int32), conf_table=None, min_step=-1.0,
        min_cumul=-1.0, track_used=False,
        forced=torch.zeros((1, 1), dtype=torch.uint8),
        forced_n=torch.zeros(1, dtype=torch.int32), hopinfo=None,
        start=torch.zeros(1, dtype=torch.int32), max_steps=10)


def test_gate_takes_the_gap_fillers_walks_on_cuda():
    w = _gap_filler_walk("cuda")
    assert lwalk._takes_kernel(w)
    assert lwalk._takes_kernel(dataclasses.replace(w, forced=None,
                                                   forced_n=None))
    assert lwalk._takes_kernel(dataclasses.replace(w, colour=None))


@pytest.mark.parametrize("change", [
    dict(adj=None),                                   # exp_abc
    dict(hopinfo=(None, None, None)),                 # bubbles, contigs -p
    dict(conf_table=torch.ones(4)),                   # contigs -p -C
    dict(missing_check=True),                         # contigs -p
    dict(track_used=True),                            # contigs -p -T
    dict(g=types.SimpleNamespace(device=torch.device("cpu")))])
def test_gate_keeps_every_other_walk_on_the_host_loop(change):
    assert not lwalk._takes_kernel(dataclasses.replace(
        _gap_filler_walk("cuda"), **change))


@pytest.mark.parametrize("with_links", [False, True])
def test_gap_fill_batch_on_cpu_counts_the_host_loop(with_links):
    """A gap-fill batch on the CPU runs the host loop: walk.plain 1,
    walk.fused 0, and walk.steps the loop's iterations (the _linked_step
    calls), which is the most steps any walker took."""
    g, reads = wc.diploid(31, "cpu", gbp=2000, n_reads=64)
    links = lthread.thread_reads(g, [(reads, 0)], 1) if with_links else None
    st, kw = wc.gapfill_walk(g, links, reads)
    calls = []
    real = lwalk._linked_step

    def step(*a, **k):
        calls.append(1)
        return real(*a, **k)

    timing.reset()
    lwalk._linked_step = step
    try:
        out = lwalk.walk_linked(
            g, links or lstore.empty(g.capacity, 1, device="cpu"), st, **kw)
    finally:
        lwalk._linked_step = real
    assert timing.COUNTERS == {"walk.fused": 0, "walk.plain": 1,
                               "walk.steps": len(calls)}
    assert len(calls) == int((out.base.nsteps - st.base.nsteps).max()) > 0
    timing.reset()
    acorrect.correct_batch(g, links, reads)
    assert timing.COUNTERS["walk.plain"] == 1
    assert timing.COUNTERS["walk.steps"] == len(calls)
    assert timing.COUNTERS["walk.fused"] == 0


def _emulate():
    spec = importlib.util.spec_from_file_location(
        "emulate", os.path.join(ROOT, "scripts", "cuda_emul", "emulate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def emulated_walk(tmp_path_factory):
    """The C entry point of csrc/walk.cu built by g++ for the CPU."""
    return _emulate().build("walk", str(tmp_path_factory.mktemp("emu")),
                            31, 13, "mctx_walk")


# case: (make, what its walks must show: full cursor slots or more than
# 16 links at a node (pickups dropped), a halt).  Four walkers each, in
# short walks: the emulation costs host threads and barriers a step.
EMULATED = {
    "gap filling with links, k=31": (lambda: wc.gapfill_case(31, "cpu"),
                                     None),
    "dropped pickups, k=63": (lambda: wc.repeat_walks(63, "cpu", every=30,
                                                      max_len=40),
                              "drops"),
    "cycle, k=31": (lambda: wc.cycle_walks(31, "cpu", with_links=False,
                                           ring_bp=40), T.HALT_CYCLE),
    "max_len halt": (lambda: wc.halt_walks(31, "cpu", 5, 50), T.HALT_MAXLEN),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_walk_kernel_on_the_cpu_matches_the_host_loop(emulated_walk,
                                                      monkeypatch, case):
    """_walk_fused as it is, its launch the kernel compiled for the CPU:
    every field of the state equal to the host loop's, from the start
    state and again resumed from where the first walk left off."""
    monkeypatch.setattr(_build, "function", lambda *a: emulated_walk)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    make, shows = EMULATED[case]
    g, links, st, kw = wc.first_walkers(make(), 4)
    want = wc.walk_both(g, links, st, kw, False)
    assert wc.differing_fields(wc.walk_both(g, links, st, kw, True),
                               want) == []
    assert wc.differing_fields(wc.walk_both(g, links, want, kw, True),
                               wc.walk_both(g, links, want, kw, False)) == []
    assert int(want.base.nsteps.max()) > 0
    if shows == "drops":
        assert int(want.n_drop.sum()) > 0
    elif shows is not None:
        assert shows in want.base.status.numpy()

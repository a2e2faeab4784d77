"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (a step that returns its state
unchanged, half of each batch left out, an answer altered where it is
produced; one chip, so no exchange between chips).  The card's check is
skipped: the tiny cells run on the CPU.  And the control, the reference
with a guarantee broken, fails the same check at the tiny size."""

import dataclasses

import pytest
from conftest import SEED

import mccortex_tpu_torch.graph.build as gbuild
import mccortex_tpu_torch.graph.clean as gclean
import mccortex_tpu_torch.io.ctp as ctpio
import mccortex_tpu_torch.io.ctx as ctxio
import mccortex_tpu_torch.links.store as lstore
import mccortex_tpu_torch.links.thread as lthread
from benchmark.harness import runner


def _half_build(monkeypatch):
    orig = gbuild.build

    def build(batches, k, *a, **kw):
        return orig([(b[:len(b) // 2], c) for b, c in batches], k, *a, **kw)
    monkeypatch.setattr(gbuild, "build", build)


def _clean_unchanged(monkeypatch):
    monkeypatch.setattr(gclean, "clean_graph", lambda g, **kw: g)


def _ctx_altered(monkeypatch):
    orig = ctxio.write_ctx

    def write_ctx(path, h, keys, covg, edges):
        covg = covg.copy()
        covg[len(covg) // 2] += 1
        return orig(path, h, keys, covg, edges)
    monkeypatch.setattr(ctxio, "write_ctx", write_ctx)


def _half_thread(monkeypatch):
    orig = lthread.thread_reads_gapfill

    def thread(g, batches, *a, **kw):
        return orig(g, [(b[:len(b) // 2], c) for b, c in batches], *a, **kw)
    monkeypatch.setattr(lthread, "thread_reads_gapfill", thread)


def _thread_unchanged(monkeypatch):
    monkeypatch.setattr(lthread, "thread_reads_gapfill",
                        lambda g, batches, ncols, **kw:
                        lstore.empty(g.capacity, ncols, device=g.device))


def _link_altered(monkeypatch):
    orig = ctpio.save_ctp

    def save_ctp(path, g, links, *a, **kw):
        nseen = links.nseen.clone()
        nseen[len(nseen) // 2] += 1
        return orig(path, g, dataclasses.replace(links, nseen=nseen), *a,
                    **kw)
    monkeypatch.setattr(ctpio, "save_ctp", save_ctp)


FAULTS = [("ecoli_k31.graph", _half_build, "raw_diff"),
          ("ecoli_k31.graph", _clean_unchanged, "clean_diff"),
          ("ecoli_k31.graph", _ctx_altered, "raw_diff"),
          ("chr22dip_k31.links", _half_thread, "links_diff"),
          ("chr22dip_k31.links", _thread_unchanged, "links_diff"),
          ("chr22dip_k31.links", _link_altered, "links_diff")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f[1].__name__.strip("_") for f in FAULTS])
def test_fault_comes_out_not_correct(tiny_root, monkeypatch, cell, fault,
                                     number):
    fault(monkeypatch)
    result, _ = runner.run_cell(tiny_root, cell, SEED, 0.1, False,
                                device="cpu")
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number][
        "limit"]


@pytest.mark.parametrize("cell,number", [("ecoli_k31.graph", "raw_diff"),
                                         ("chr22dip_k31.links",
                                          "links_diff")])
def test_control_fails_the_check(tiny_root, cell, number, capsys):
    import json
    from benchmark.tools import control
    control.main(["--root", tiny_root, "--workload", cell, "--seeds",
                  str(SEED), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control"][number] > 0

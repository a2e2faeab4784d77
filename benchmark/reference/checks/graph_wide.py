"""The check of a graph job (build -> clean -T -U -> unitigs) at any odd
k <= 63: the rows of checks/graph.py, worked out by the two-word
reference (dbg_wide.py) from the same reads.  The raw graph, the
cleaned graph and the unitigs of the window's last completed job
against the reference's, and every other completed job's output files
against that job's (the inputs are the same, so the outputs must be).

The records are compared on the run's device by sorting and searching
the two-word keys (compare.record_diff's sort of 16-byte strings takes
minutes at tens of millions of kmers); the count is compare.record_diff's.
"""

import numpy as np
import torch

from benchmark.reference import compare, dbg_wide


def _keys_of(ctx_keys: np.ndarray, device) -> torch.Tensor:
    """(n, 2) int64 [hi, lo] of a .ctx's (n, W) uint64 keys, W <= 2."""
    w = torch.from_numpy(np.ascontiguousarray(ctx_keys).view(np.int64)).to(
        device)
    if w.shape[1] == 1:
        w = torch.cat([torch.zeros_like(w), w], dim=1)
    return w


def record_diff(got: tuple, want: tuple, device) -> int:
    """Kmers whose record (coverage and edges) differs between the
    program's graph `got` (compare.read_ctx's form, one colour) and the
    reference's `want` (keys (n, 2) ascending, covg, edges tensors), that
    one graph holds and the other lacks, or that `got` holds twice."""
    keys = _keys_of(got[0], device)
    covg = torch.from_numpy(got[1][:, 0].astype(np.int64)).to(device)
    edges = torch.from_numpy(got[2][:, 0].astype(np.int64)).to(device)
    o = dbg_wide.order(keys[:, 0], keys[:, 1])
    keys, covg, edges = keys[o], covg[o], edges[o]
    first = torch.ones(len(keys), dtype=torch.bool, device=device)
    first[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    rep = int((~first).sum())
    keys, covg, edges = keys[first], covg[first], edges[first]
    wk, wc, we = (t.to(device) for t in want)
    j, found = dbg_wide.find(wk, keys[:, 0], keys[:, 1])
    inter = int(found.sum())
    differ = int((found & ((covg != wc[j]) | (edges != we[j]))).sum())
    return int(len(got[0]) - inter + len(wk) - inter + differ + rep)


def numbers(got_raw, got_clean, got_unitigs, raw, k, device) -> list:
    """(name, value, limit) rows: records or unitigs that differ from
    those of the reference's raw graph `raw` (keys, covg, edges)."""
    rows = [("raw_diff", record_diff(got_raw, raw, device), 0)]
    clean = dbg_wide.clean(*raw, k)
    rows.append(("clean_diff", record_diff(got_clean, clean, device), 0))
    rows.append(("unitigs_diff", compare.unitig_diff(
        got_unitigs, dbg_wide.unitigs(clean[0], clean[2], k)), 0))
    return rows


def check(run) -> list:
    done = run.done
    if not done:
        return [("jobs_completed", 0, -1)]
    raw, clean, fasta = run.driver.expand(run.traffic["job"]["outputs"],
                                          done[-1].index)
    k = run.config["k"]
    rows = numbers(compare.read_ctx(raw), compare.read_ctx(clean),
                   compare.read_fasta(fasta),
                   dbg_wide.build(run.driver.reads, k, run.device), k,
                   run.device)
    last = done[-1].digests
    rows.append(("jobs_differing", sum(j.digests != last for j in done), 0))
    return rows

"""The check of a plain threading job (thread --no-gap-fill of a whole
sample): the set-up's cleaned graph against the plain reference's,
worked out from the same reads, and the links of one of the window's
completed jobs, drawn from the seed, against the reference's threading
of the same reads on its own graph: every link record and the header's
contig-length histogram.

Without gap filling a read adds links only where one of its kmers is a
fork (more than one edge out, in either orientation): links.thread runs
on those reads alone.  Every other read adds each of its aligned
stretches to the histogram, which one vectorised pass counts.
"""

import collections
import os

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.reference import compare, dbg
from benchmark.reference import links as rlinks

BLOCK = 1 << 16          # reads a block of the vectorised pass
_links = spec.check_module("links")     # the gap-filled cell's check


def _vertices(keys: torch.Tensor, reads: np.ndarray, k: int):
    """links.Graph.vertices on the device: (B, L - k + 1) vertex of each
    window of reads, -1 where the kmer is absent or the window holds a
    code that is no base."""
    r = torch.from_numpy(np.ascontiguousarray(reads)).to(keys.device,
                                                         torch.int64)
    P = r.shape[1] - k + 1
    key, orient = dbg.kmers_of(r & 3, k)
    bad = torch.zeros((r.shape[0], r.shape[1] + 1), dtype=torch.int64,
                      device=keys.device)
    bad[:, 1:] = torch.cumsum((r > 3).to(torch.int64), dim=1)
    bad = (bad[:, k:k + P] - bad[:, :P]) > 0
    if len(keys) == 0:
        return torch.full(key.shape, -1, dtype=torch.int64,
                          device=keys.device)
    j = torch.searchsorted(keys, key).clamp(max=len(keys) - 1)
    hit = (keys[j] == key) & ~bad
    return torch.where(hit, 2 * j + orient, -1)


def thread_plain(g: rlinks.Graph, reads: np.ndarray, device) -> tuple:
    """links.thread(g, reads, gap_fill=False): (links Counter, contig
    histogram), with the reads that touch no fork counted in bulk."""
    outdeg = np.asarray(g.outdeg)
    fork = (outdeg > 1) | (outdeg.reshape(-1, 2)[:, ::-1].reshape(-1) > 1)
    fork = torch.from_numpy(fork).to(device)
    keys = torch.from_numpy(g.keys).to(device)
    touch = np.zeros(len(reads), bool)
    lengths = []
    for s in range(0, len(reads), BLOCK):
        v = _vertices(keys, reads[s:s + BLOCK], g.k)
        al = v >= 0
        t = (al & fork[v.clamp(min=0)]).any(dim=1)
        touch[s:s + BLOCK] = t.cpu().numpy()
        # each aligned stretch of the other reads: +1 at its start, -1
        # one past its end, in rows padded with a hole on either side
        a = torch.nn.functional.pad(al[~t].to(torch.int8), (1, 1))
        d = (a[:, 1:] - a[:, :-1]).reshape(-1)
        starts = torch.nonzero(d == 1).reshape(-1)
        ends = torch.nonzero(d == -1).reshape(-1)
        lengths.append((ends - starts).cpu().numpy())
    links, hist = rlinks.thread(g, reads[touch], gap_fill=False)
    hist = collections.Counter(hist)
    sizes, counts = np.unique(np.concatenate(lengths + [np.zeros(0, int)]),
                              return_counts=True)
    for n, c in zip(sizes.tolist(), counts.tolist()):
        hist[n + g.k - 1] += c
    return links, dict(hist)


def check(run) -> list:
    if not run.done:
        return [("jobs_completed", 0, -1)]
    k, work = run.config["k"], run.driver.work
    clean = _links.reference_graph(run.driver.reads, k, run.device)
    rows = [("graph_diff", compare.record_diff(
        compare.read_ctx(os.path.join(work, "clean.ctx")),
        compare.records(*clean)), 0)]
    job = _links.pick(run)
    path = run.driver.expand(run.traffic["job"]["outputs"], job.index)[0]
    reads = run.driver.chunk_reads(run.traffic["job"]["input"], job.index)
    g = rlinks.Graph(clean[0].cpu().numpy(), clean[2].cpu().numpy(), k)
    links, hist = thread_plain(g, reads, run.device)
    got, got_h = compare.read_ctp(path)
    return rows + [
        ("links_diff", compare.links_diff(got, rlinks.records(g, links)), 0),
        ("hist_diff", compare.hist_diff(got_h, {0: hist}), 0)]

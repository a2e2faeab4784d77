"""The check of a threading job (thread, gap-filled): the set-up's
cleaned graph against the plain reference's, worked out from the same
reads, and the links of one of the window's completed jobs, drawn from
the seed, against the reference's threading of the same chunk on its
own graph: every link record (kmer, strand, junctions, counts, bases)
and the header's contig-length histogram."""

import os

import numpy as np

from benchmark.reference import compare, dbg
from benchmark.reference import links as rlinks


def reference_graph(reads, k, device) -> tuple:
    """The reference's cleaned graph: (keys, covg, edges) tensors."""
    return dbg.clean(*dbg.build(reads, k, device), k)


def link_numbers(got_path, chunk, clean, k) -> list:
    """links_diff and hist_diff of the program's .ctp file against the
    reference's threading of `chunk` on its cleaned graph."""
    g = rlinks.Graph(clean[0].cpu().numpy(), clean[2].cpu().numpy(), k)
    links, hist = rlinks.thread(g, chunk)
    got, got_h = compare.read_ctp(got_path)
    return [("links_diff", compare.links_diff(got, rlinks.records(g, links)),
             0),
            ("hist_diff", compare.hist_diff(got_h, {0: hist}), 0)]


def pick(run):
    """The completed job whose links are checked, drawn from the seed."""
    rng = np.random.default_rng([run.seed, 7])
    return run.done[int(rng.integers(len(run.done)))]


def check(run) -> list:
    if not run.done:
        return [("jobs_completed", 0, -1)]
    k, work = run.config["k"], run.driver.work
    clean = reference_graph(run.driver.reads, k, run.device)
    rows = [("graph_diff", compare.record_diff(
        compare.read_ctx(os.path.join(work, "clean.ctx")),
        compare.records(*clean)), 0)]
    job = pick(run)
    path = run.driver.expand(run.traffic["job"]["outputs"], job.index)[0]
    chunk = run.driver.chunk_reads(run.traffic["job"]["input"], job.index)
    return rows + link_numbers(path, chunk, clean, k)

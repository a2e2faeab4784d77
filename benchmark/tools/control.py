"""The control of each cell's check, at the cell's own size: the plain
reference put in the program's place with one guarantee of the
configuration broken, compared by the cell's own check.  Its numbers are
the upper readings that the limits in PERF.md were set below.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3

- graph cells: the reference's graph with every count saturated at 255
  (uint8 counters in place of the uint32 that .ctx stores), cleaned and
  split into unitigs, against the reference;
- links cells: the reference's threading with gap filling off (as the
  program's `thread --no-gap-fill` threads), written as a .ctp file and
  read back as the program's is, against the reference's gap-filled
  threading of the same chunk.

It prints one JSON line a seed.  The benchmark's own runs never run it.
"""

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.data import synth  # noqa: E402
from benchmark.harness import spec as bspec  # noqa: E402
from benchmark.reference import compare, dbg  # noqa: E402
from benchmark.reference import links as rlinks  # noqa: E402
from benchmark.reference.checks import graph as graph_check  # noqa: E402
from benchmark.reference.checks import links as links_check  # noqa: E402


def graph_control(cell, reads, device) -> list:
    k = cell.config["k"]
    raw = dbg.build(reads, k, device)
    keys, covg, edges = raw[0], raw[1].clamp(max=255), raw[2]
    clean = dbg.clean(keys, covg, edges, k)
    unitigs = dbg.unitigs(clean[0], clean[2], k)
    return graph_check.numbers(compare.records(keys, covg, edges),
                               compare.records(*clean), unitigs, raw, k)


def links_control(cell, reads, device, seed) -> list:
    k = cell.config["k"]
    n = next(s["chunk_reads"] for s in cell.traffic["inputs"]
             if "chunk_reads" in s)
    i = int(np.random.default_rng([seed, 7]).integers(len(reads) // n))
    chunk = reads[i * n:(i + 1) * n]
    clean = links_check.reference_graph(reads, k, device)
    g = rlinks.Graph(clean[0].cpu().numpy(), clean[2].cpu().numpy(), k)
    links, hist = rlinks.thread(g, chunk, gap_fill=False)
    work = tempfile.mkdtemp(prefix="mctx-control-")
    try:
        path = os.path.join(work, "control.ctp.gz")
        write_ctp(path, g, links, hist)
        return links_check.link_numbers(path, chunk, clean, k)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_ctp(path, g, links, hist) -> None:
    """The control's links as a .ctp file that compare.read_ctp reads:
    the header's contig histogram and one line a record."""
    lens = sorted(hist)
    hdr = {"paths": {"contig_hists": [{"lengths": lens,
                                       "counts": [hist[x] for x in lens]}]}}
    by_kmer = {}
    for kmer, *rest in rlinks.records(g, links):
        by_kmer.setdefault(kmer, []).append(" ".join(rest))
    with gzip.open(path, "wt") as fh:
        fh.write(json.dumps(hdr) + "\n\n")
        for kmer, recs in by_kmer.items():
            fh.write(f"{kmer} {len(recs)}\n" + "".join(r + "\n"
                                                      for r in recs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=ROOT)
    args = p.parse_args(argv)
    cell = bspec.Cell(args.root, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        reads = synth.make_sample(cell.config["sample"], seed)
        if cell.traffic["check"] == "graph":
            rows = graph_control(cell, reads, args.device)
        else:
            rows = links_control(cell, reads, args.device, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {n: v for n, v, _ in rows},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

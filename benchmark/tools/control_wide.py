"""The control of the checks `graph_wide` and `links_plain`, at the cell's
own size: the plain reference put in the program's place with its counts
held in one byte (saturating at 255) where the configuration states four,
compared by the cell's own check.  Its numbers are the upper readings
that the limits in PERF.md were set below.

    python3 benchmark/tools/control_wide.py --workload <cell> --seeds 1 2

- `graph_wide` cells: the reference's graph with every count saturated
  at 255 (uint8 counters in place of the uint32 that .ctx stores),
  cleaned and split into unitigs, against the reference;
- `links_plain` cells: the reference's plain threading of the whole
  sample with every link count and every count of the contig histogram
  saturated at 255, written as a .ctp file and read back as the
  program's is, against the reference.

It prints one JSON line a seed.  The benchmark's own runs never run it.
"""

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.data import synth  # noqa: E402
from benchmark.harness import spec as bspec  # noqa: E402
from benchmark.reference import compare, dbg_wide  # noqa: E402
from benchmark.reference import links as rlinks  # noqa: E402
from benchmark.tools.control import write_ctp  # noqa: E402

BYTE = 255


def graph_wide_control(cell, reads, device) -> list:
    k = cell.config["k"]
    raw = dbg_wide.build(reads, k, device)
    keys, covg, edges = raw[0], raw[1].clamp(max=BYTE), raw[2]
    clean = dbg_wide.clean(keys, covg, edges, k)
    unitigs = dbg_wide.unitigs(clean[0], clean[2], k)
    return bspec.check_module("graph_wide").numbers(
        dbg_wide.records(keys, covg, edges, k),
        dbg_wide.records(*clean, k), unitigs, raw, k, device)


def links_plain_control(cell, reads, device) -> list:
    k = cell.config["k"]
    check = bspec.check_module("links_plain")
    clean = bspec.check_module("links").reference_graph(reads, k, device)
    g = rlinks.Graph(clean[0].cpu().numpy(), clean[2].cpu().numpy(), k)
    links, hist = check.thread_plain(g, reads, device)
    byte_links = collections.Counter(
        {key: min(c, BYTE) for key, c in links.items()})
    byte_hist = {n: min(c, BYTE) for n, c in hist.items()}
    work = tempfile.mkdtemp(prefix="mctx-control-")
    try:
        path = os.path.join(work, "control.ctp.gz")
        write_ctp(path, g, byte_links, byte_hist)
        got, got_h = compare.read_ctp(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [("links_diff", compare.links_diff(got, rlinks.records(g, links)),
             0),
            ("hist_diff", compare.hist_diff(got_h, {0: hist}), 0)]


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
        if cell.traffic["check"] == "graph_wide":
            rows = graph_wide_control(cell, reads, args.device)
        else:
            rows = links_plain_control(cell, reads, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {n: v for n, v, _ in rows},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

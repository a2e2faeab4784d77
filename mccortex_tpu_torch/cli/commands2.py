"""mctx-torch subcommands of mccortex_tpu/cli/commands2.py: subgraph,
join, pjoin, dist, sort, index, uniqkmers, rmsubstr, reads, coverage,
popbubbles, server and exp_abc.
join rebuilds its store on the device (graph/store.from_records: the
sort and segreduce kernels on the card) and intersects through the
batched lookup;
subgraph probes its seed kmers through the lookup and walks the
adjacency; dist and sort run on the device; pjoin merges link files
(io/ctp.py, links/store.py); index, uniqkmers and rmsubstr are host
code; reads and coverage map reads to node paths through the batched
lookup (links/thread.reads_to_node_paths), one lookup per padded read
length; popbubbles calls the bubbles of calls/bubbles.py and prunes one
branch of each on the device; server answers kmer queries through the
batched lookup (or, with --disk, the .ctx file's block index); exp_abc
runs two batched linked walks.
"""

from __future__ import annotations

import argparse
import gzip
import random
import sys

import numpy as np
import torch

from .commands import (_load_graph, _load_graphs, _save_graph,
                       intersect_store)
from .common import (add_common, apply_common, check_kmer, check_outfile,
                     parse_size)


# ---------------------------------------------------------------------------
# subgraph (ref ctx_subgraph.c)
# ---------------------------------------------------------------------------

def cmd_subgraph(argv):
    p = argparse.ArgumentParser(prog="mctx-torch subgraph")
    p.add_argument("-1", "--seq", action="append", required=True)
    p.add_argument("-d", "--dist", type=int, default=0,
                   help="number of kmers to extend by [default: 0]")
    p.add_argument("-v", "--invert", action="store_true",
                   help="dump kmers NOT in the subgraph")
    p.add_argument("-U", "--unitigs", action="store_true",
                   help="grab whole unitigs containing seed kmers")
    p.add_argument("-N", "--ncols", type=int, default=None,
                   help="colours to load at once (ref memory knob; all "
                        "colours load in one pass here)")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    from ..graph import subgraph as sg
    from ..io import seqio
    from ..utils import timing
    timing.reset()
    h, g = _load_graphs(args.ctx, device)
    batches = [codes for codes, _, _ in seqio.read_batches(args.seq)]
    g2 = sg.subgraph(g, batches, dist=args.dist, invert=args.invert,
                     whole_unitigs=args.unitigs)
    status(f"subgraph: {g.n} -> {g2.n} kmers")
    _save_graph(args.out, h, g2)
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# join: merge graphs with colour offsets
# ---------------------------------------------------------------------------

def cmd_join(argv):
    p = argparse.ArgumentParser(prog="mctx-torch join")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--flatten", action="store_true",
                   help="sum all colours into one")
    p.add_argument("-i", "--intersect", action="append", default=[],
                   help="only keep kmers present in this graph "
                        "(repeatable = intersection of all of them); the "
                        "graph itself is NOT merged into the output")
    p.add_argument("-N", "--ncols", type=int, default=None,
                   help="colours to load at once (accepted for parity: "
                        "all colours load in one pass)")
    p.add_argument("-S", "--sort", action="store_true",
                   help="output sorted graph (always true: .ctx is "
                        "written sorted)")
    p.add_argument("ctx", nargs="+",
                   help="input graphs; 'N:file.ctx' loads file at colour "
                        "offset N; 'file.ctx:0,2-3' selects colours")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    from ..graph import store as gstore
    from ..io import ctx as ctxio

    inputs = []
    for spec in args.ctx:
        off, cols = None, None
        path = spec
        if ":" in spec and spec.split(":")[0].isdigit():
            off, path = spec.split(":", 1)
            off = int(off)
        if ":" in path and not path.split(":")[-1].endswith(".ctx"):
            # colour selection suffix: "in.ctx:0,2-3,*"
            path, colspec = path.rsplit(":", 1)
            cols = _parse_colour_range(colspec)
        h, keys, covg, edges = ctxio.read_ctx(path)
        if cols is not None:
            sel = [c for c in cols if c < h.ncols] if cols != "*" \
                else list(range(h.ncols))
            covg = covg[:, sel]
            edges = edges[:, sel]
            h.ginfo = [h.ginfo[c] for c in sel]
            keep = covg.sum(axis=1) > 0
            keys, covg, edges = keys[keep], covg[keep], edges[keep]
        inputs.append((off, h, keys, covg, edges))

    k = inputs[0][1].kmer_size
    for off, h, *_ in inputs:
        if h.kmer_size != k:
            raise ValueError("kmer sizes differ between inputs")

    # colour offsets: given, or after the colours placed so far
    ncols_out = 0
    placed = []
    next_off = 0
    for off, h, keys, covg, edges in inputs:
        o = off if off is not None else next_off
        placed.append((o, h, keys, covg, edges))
        next_off = max(next_off, o + h.ncols)
        ncols_out = max(ncols_out, o + h.ncols)
    if args.flatten:
        ncols_out = 1

    ginfo = [ctxio.GraphInfo() for _ in range(ncols_out)]
    allk, allc, alle = [], [], []
    for o, h, keys, covg, edges in placed:
        C = h.ncols
        cw = np.zeros((len(keys), ncols_out), np.uint32)
        ew = np.zeros((len(keys), ncols_out), np.uint8)
        if args.flatten:
            cw[:, 0] = covg.sum(axis=1)
            for c in range(C):
                ew[:, 0] |= edges[:, c]
        else:
            cw[:, o:o + C] = covg
            ew[:, o:o + C] = edges
            for c in range(C):
                gi = ginfo[o + c]
                gi.sample_name = h.ginfo[c].sample_name
                gi.total_sequence += h.ginfo[c].total_sequence
                gi.mean_read_length = max(gi.mean_read_length,
                                          h.ginfo[c].mean_read_length)
        allk.append(keys)
        allc.append(cw)
        alle.append(ew)

    g = gstore.from_records(
        k, torch.from_numpy(np.concatenate(allk).view(np.int64)).to(device),
        torch.from_numpy(np.concatenate(allc).view(np.int32)).to(device),
        torch.from_numpy(np.concatenate(alle)).to(device))
    for ipath in args.intersect:
        hi, ikeys, _ic, _ie = ctxio.read_ctx(ipath)
        if hi.kmer_size != k:
            raise ValueError(f"{ipath}: kmer size mismatch")
        g = intersect_store(g, ikeys)
        status(f"intersected with {ipath}: {g.n} kmers remain")
    _save_graph(args.out, ctxio.CtxHeader(kmer_size=k, ginfo=ginfo), g)
    status(f"joined {len(inputs)} graphs -> {g.n} kmers x "
           f"{ncols_out} colours")
    return 0


def _parse_colour_range(spec):
    """Parse "1,3-5" colour selections ("*" = every colour)."""
    if spec == "*":
        return "*"
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


# ---------------------------------------------------------------------------
# dist: colour x colour shared-kmer matrix
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# pjoin (ref ctx_pjoin.c): merge link files
# ---------------------------------------------------------------------------

def cmd_pjoin(argv):
    p = argparse.ArgumentParser(prog="mctx-torch pjoin")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-g", "--graph", default=None,
                   help="alias for the positional graph argument "
                        "(ref ctx_pjoin.c -g)")
    p.add_argument("-c", "--outcols", type=int, default=None,
                   help="number of colours in the output link file")
    p.add_argument("-r", "--noredundant", action="store_true",
                   help="remove redundant links (duplicates merge, "
                        "strict prefixes drop; ref gpath_subset "
                        "rmsubstr)")
    p.add_argument("ctx", nargs="?", default=None)
    p.add_argument("ctp", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    import dataclasses
    from ..io import ctp as ctpio
    from ..links import store as lstore
    ctxpath = args.graph or args.ctx
    if ctxpath is None:
        p.error("a graph file is required (positional or -g)")
    if args.graph and args.ctx:
        # both given: the positional was actually the first .ctp
        args.ctp.insert(0, args.ctx)
    h, g = _load_graph(ctxpath, device)
    links = ctpio.load_link_store(args.ctp, g)
    if args.noredundant:
        before = links.nlinks
        links = lstore.rmsubstr_store(links)
        status(f"noredundant: {before} -> {links.nlinks} links")
    if args.outcols is not None:
        C = links.nseen.shape[1]
        if args.outcols < C:
            p.error(f"--outcols {args.outcols} < input colours {C}")
        if args.outcols > C:
            ns = torch.zeros((links.nlinks, args.outcols), dtype=torch.int32,
                             device=links.device)
            ns[:, :C] = links.nseen
            links = dataclasses.replace(links, nseen=ns)
    if links.nseen.shape[1] > len(h.ginfo):
        # the header names a sample per colour, from the graph (mctx
        # fails here on an IndexError)
        p.error(f"{links.nseen.shape[1]} link colours > {len(h.ginfo)} "
                f"graph colours")
    ctpio.save_ctp(args.out, g, links,
                   sample_names=[gi.sample_name for gi in h.ginfo])
    status(f"merged {len(args.ctp)} link files -> {links.nlinks} links")
    return 0


def cmd_dist(argv):
    p = argparse.ArgumentParser(prog="mctx-torch dist")
    p.add_argument("-o", "--out", default="-",
                   help="output matrix, tab separated [default: STDOUT]")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    _status, device = apply_common(args, args.out)
    h, g = _load_graph(args.ctx, device)
    # mat[i, j] = kmers present in colours i and j; float64 products of
    # 0/1 values are exact up to 2**53 kmers
    present = (g.covg[:g.n] != 0).to(torch.float64)
    mat = (present.T @ present).to(torch.int64).cpu().numpy()
    C = h.ncols
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        out.write("\t" + "\t".join(gi.sample_name for gi in h.ginfo) + "\n")
        for i in range(C):
            out.write(h.ginfo[i].sample_name + "\t"
                      + "\t".join(str(mat[i, j]) for j in range(C)) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ---------------------------------------------------------------------------
# sort / index: graphs are always written sorted; sort re-sorts foreign
# files, index writes block offsets
# ---------------------------------------------------------------------------

def cmd_sort(argv):
    p = argparse.ArgumentParser(prog="mctx-torch sort")
    p.add_argument("-o", "--out", default=None,
                   help="output file [default: overwrite input in place]")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    # rewriting the input in place is the default: no force check
    status, device = apply_common(
        args, args.out if args.out != args.ctx else None)
    from ..io import ctx as ctxio
    from ..ops import sorted as sops
    h, keys, covg, edges = ctxio.read_ctx(args.ctx)
    skeys, scovg, sedges = sops.sort_by_key(
        torch.from_numpy(keys.view(np.int64)).to(device),
        torch.from_numpy(covg.view(np.int32)).to(device),
        torch.from_numpy(edges).to(device))
    ctxio.write_ctx(args.out or args.ctx, h,
                    skeys.cpu().numpy().view(np.uint64),
                    scovg.cpu().numpy().view(np.uint32), sedges.cpu().numpy())
    status(f"sorted {len(keys)} kmers")
    return 0


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="mctx-torch index")
    p.add_argument("-b", "--block-kmers", type=int, default=None,
                   help="kmers per block [default: 4096]")
    p.add_argument("-s", "--block-size", default=None,
                   help="block size in BYTES, e.g. 4M (converted to kmers "
                        "from the record size)")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    from ..io import ctx as ctxio
    from ..utils.text import kmers_to_strings
    out = args.out or (args.ctx + ".idx")
    status, _device = apply_common(args, out)
    h, keys, _covg, _edges = ctxio.read_ctx(args.ctx)
    bk = args.block_kmers
    if args.block_size is not None:
        if bk is not None:
            p.error("give either --block-kmers or --block-size")
        recbytes = 8 * h.W + h.ncols * 5
        bk = max(1, parse_size(args.block_size) // recbytes)
    if bk is None:
        bk = 4096
    firsts = kmers_to_strings(keys[::bk], h.kmer_size)
    with open(out, "w") as fh:
        fh.write("#block_start_kmer\tindex\tnkmers\n")
        for b, s in enumerate(range(0, len(keys), bk)):
            fh.write(f"{firsts[b]}\t{s}\t{min(bk, len(keys) - s)}\n")
    status(f"indexed {len(keys)} kmers in blocks of {bk}")
    return 0


# ---------------------------------------------------------------------------
# uniqkmers: random kmers absent from the given sequences and graph
# ---------------------------------------------------------------------------

def cmd_uniqkmers(argv):
    p = argparse.ArgumentParser(prog="mctx-torch uniqkmers")
    p.add_argument("-k", "--kmer", type=int, required=True)
    p.add_argument("-F", "--flank", default=None,
                   help="FASTA whose sequences get unique flanks appended")
    p.add_argument("-g", "--graph", default=None,
                   help="also avoid kmers in this .ctx graph")
    p.add_argument("-1", "--seq", action="append", default=[],
                   help="also avoid kmers present in this sequence file")
    p.add_argument("-o", "--out", default="-",
                   help="output file [default: STDOUT]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("num", type=int)
    add_common(p)
    args = p.parse_args(argv)
    apply_common(args, args.out)
    from ..io import seqio
    from ..utils.dna import revcomp
    rng = random.Random(args.seed)
    k = args.kmer
    check_kmer(k, p)

    taken = set()

    def add_seq_kmers(seq):
        for i in range(len(seq) - k + 1):
            km = seq[i:i + k]
            taken.add(min(km, revcomp(km)))

    seqs = []
    if args.flank:
        for rd in seqio.parse_reads(args.flank):
            seqs.append((rd.name, rd.seq))
            add_seq_kmers(rd.seq)
    for sf in args.seq:
        for rd in seqio.parse_reads(sf):
            add_seq_kmers(rd.seq)
    if args.graph:
        from ..io import ctx as ctxio
        from ..utils.text import kmers_to_strings
        h, keys, _, _ = ctxio.read_ctx(args.graph)
        if h.kmer_size == k:
            taken.update(kmers_to_strings(keys, k))

    def fresh_kmer():
        while True:
            km = "".join(rng.choice("ACGT") for _ in range(k))
            key = min(km, revcomp(km))
            if key not in taken:
                taken.add(key)
                return km

    ofh = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        # a unique kmer either side of each sequence, drawn again until
        # the kmers across the junctions are unique too
        for name, seq in seqs:
            for _ in range(1000):
                left, right = fresh_kmer(), fresh_kmer()
                full = left + seq + right
                border = [full[i:i + k] for i in range(0, 2 * k)] + \
                    [full[i:i + k]
                     for i in range(len(full) - 2 * k, len(full) - k + 1)]
                counts = {}
                for i in range(len(full) - k + 1):
                    key = min(full[i:i + k], revcomp(full[i:i + k]))
                    counts[key] = counts.get(key, 0) + 1
                if all(counts[min(b, revcomp(b))] == 1 for b in border):
                    ofh.write(f">{name}\n{full}\n")
                    break
            else:
                raise ValueError("could not generate unique flanks")
        for i in range(args.num):
            ofh.write(f">kmer{i}\n{fresh_kmer()}\n")
    finally:
        if ofh is not sys.stdout:
            ofh.close()
    return 0


# ---------------------------------------------------------------------------
# rmsubstr: drop sequences that are substrings of others
# ---------------------------------------------------------------------------

class _SeqWriter:
    """FASTA/FASTQ writer, gzip when the path ends .gz."""

    def __init__(self, path, fmt):
        self.fmt = fmt
        self.fh = (gzip.open(path, "wt") if str(path).endswith(".gz")
                   else (sys.stdout if path == "-" else open(path, "w")))

    def write(self, rd):
        if self.fmt == "fastq":
            q = rd.quals
            qs = ("".join(chr(min(int(x), 93) + 33) for x in q)
                  if q is not None else "?" * len(rd.seq))
            self.fh.write(f"@{rd.name}\n{rd.seq}\n+\n{qs}\n")
        else:
            self.fh.write(f">{rd.name}\n{rd.seq}\n")

    def close(self):
        if self.fh is not sys.stdout:
            self.fh.close()


def cmd_rmsubstr(argv):
    p = argparse.ArgumentParser(prog="mctx-torch rmsubstr")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-k", "--kmer", type=int, default=None,
                   help="accepted for parity (matching is exact substring "
                        "search)")
    p.add_argument("-F", "--format", default="fasta",
                   type=lambda s: s.lower(), choices=["fasta", "fastq"],
                   help="output format [default: FASTA]")
    p.add_argument("-v", "--invert", action="store_true",
                   help="only print sequences that ARE substrings of "
                        "others")
    p.add_argument("fasta", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, _device = apply_common(args, args.out)
    from ..io import seqio
    from ..utils.dna import revcomp
    reads = [rd for f in args.fasta for rd in seqio.parse_reads(f)]
    reads.sort(key=lambda r: -len(r.seq))
    kept, dropped = [], []
    for rd in reads:
        rc = revcomp(rd.seq)
        dup = any(rd.seq in other or rc in other for other, _r in kept)
        (dropped if dup else kept).append((rd.seq, rd))
    out = _SeqWriter(args.out, args.format)
    try:
        for _seq, rd in (dropped if args.invert else kept):
            out.write(rd)
    finally:
        out.close()
    status(f"rmsubstr: kept {len(kept)}/{len(reads)}")
    return 0


# ---------------------------------------------------------------------------
# reads (ref ctx_reads.c): filter reads by graph membership
# ---------------------------------------------------------------------------

# reads a lookup batch of `reads` and `coverage`
_CHUNK = 4096


def _pow2_len(n: int) -> int:
    """The padded row length of a read of n bases: the next power of two
    (a few fixed shapes over a whole run, as in the JAX package)."""
    return 1 << max(n - 1, 1).bit_length()


def _codes(seq: str) -> np.ndarray:
    from ..constants import CHAR_TO_BASE
    return CHAR_TO_BASE[np.frombuffer(seq.encode(), np.uint8)]


def _chunks(it, n: int):
    """Lists of n items of `it` (the last may be shorter)."""
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


def _node_paths_by_length(g, seqs, rows):
    """Node paths of the sequences seqs[i] for i in rows (each at least k
    bases), one batched lookup per padded length: yields (rows of the
    bucket, idx, orient, valid) host arrays."""
    from ..links import thread as lthread
    buckets = {}
    for i in rows:
        buckets.setdefault(_pow2_len(len(seqs[i])), []).append(i)
    for L, idxs in buckets.items():
        arr = np.full((len(idxs), L), 4, np.uint8)
        for r, i in enumerate(idxs):
            arr[r, :len(seqs[i])] = _codes(seqs[i])
        idx, orient, valid = lthread.reads_to_node_paths(g, arr, g.k)
        yield idxs, idx.cpu().numpy(), orient.cpu().numpy(), \
            valid.cpu().numpy()


def _reads_touch_graph(g, reads) -> np.ndarray:
    """True per read iff any of its kmers is in the graph: one lookup per
    padded length (on a CUDA store, the lookup kernel)."""
    out = np.zeros(len(reads), bool)
    seqs = [rd.seq for rd in reads]
    rows = [i for i, s in enumerate(seqs) if len(s) >= g.k]
    for idxs, _idx, _orient, valid in _node_paths_by_length(g, seqs, rows):
        out[np.asarray(idxs)] = valid.any(axis=1)
    return out


def cmd_reads(argv):
    p = argparse.ArgumentParser(
        prog="mctx-torch reads",
        description="filter reads by graph membership (ref ctx_reads.c); "
                    "a pair is kept when EITHER mate touches the graph")
    p.add_argument("-1", "--seq", action="append", default=[],
                   help="<in>[:<O>] — write kept reads to <O>.fq.gz "
                        "(plain <in> uses -o)")
    p.add_argument("-2", "--seq2", action="append", default=[],
                   help="<in1>:<in2>:<O> — paired output <O>.{1,2}.fq.gz")
    p.add_argument("-i", "--seqi", action="append", default=[],
                   help="<in>:<O> — interleaved pairs, output "
                        "<O>.{1,2}.fq.gz")
    p.add_argument("-F", "--format", default="fastq",
                   type=lambda s: s.lower(),
                   choices=["fasta", "fastq"],
                   help="output format [default: FASTQ, ref ctx_reads.c]")
    p.add_argument("-o", "--out", default=None,
                   help="output for plain --seq inputs")
    p.add_argument("-v", "--invert", action="store_true",
                   help="keep reads/pairs with NO kmer in graph")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for parity")
    p.add_argument("ctx")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    from ..io import seqio
    from ..utils import timing
    timing.reset()
    h, g = _load_graph(args.ctx, device)
    ext = ".fq.gz" if args.format == "fastq" else ".fa.gz"
    kept = total = 0

    def _filter_se(path, wr):
        nonlocal kept, total
        for rds in _chunks(seqio.parse_reads(path), _CHUNK):
            total += len(rds)
            with timing.span("lookup", device):
                touch = _reads_touch_graph(g, rds)
            for rd, t in zip(rds, touch):
                if bool(t) != args.invert:
                    wr.write(rd)
                    kept += 1

    for spec in args.seq:
        if ":" in spec:
            path, obase = spec.rsplit(":", 1)
            check_outfile(obase + ext, args.force)
            wr = _SeqWriter(obase + ext, args.format)
        else:
            if not args.out:
                p.error(f"--seq {spec}: give <in>:<out> or -o")
            check_outfile(args.out, args.force)
            fmt = args.format
            if not args.out.endswith(".gz") and not any(
                    args.out.endswith(e) for e in (".fq", ".fastq")):
                fmt = "fasta" if args.out.endswith((".fa", ".fasta")) \
                    else args.format
            wr = _SeqWriter(args.out, fmt)
            path = spec
        _filter_se(path, wr)
        wr.close()

    def _filter_pairs(pair_iter, obase):
        nonlocal kept, total
        w1 = _SeqWriter(obase + ".1" + ext, args.format)
        w2 = _SeqWriter(obase + ".2" + ext, args.format)
        for pairs in _chunks(pair_iter, _CHUNK):
            total += 2 * len(pairs)
            with timing.span("lookup", device):
                t1 = _reads_touch_graph(g, [q[0] for q in pairs])
                t2 = _reads_touch_graph(g, [q[1] for q in pairs])
            for (r1, r2), t in zip(pairs, t1 | t2):
                if bool(t) != args.invert:
                    w1.write(r1)
                    w2.write(r2)
                    kept += 2
        w1.close()
        w2.close()

    for spec in args.seq2:
        try:
            in1, in2, obase = spec.rsplit(":", 2)
        except ValueError:
            p.error(f"--seq2 needs <in1>:<in2>:<out>: {spec}")
        check_outfile(obase + ".1" + ext, args.force)
        check_outfile(obase + ".2" + ext, args.force)
        _filter_pairs(zip(seqio.parse_reads(in1), seqio.parse_reads(in2)),
                      obase)
    for spec in args.seqi:
        try:
            in1, obase = spec.rsplit(":", 1)
        except ValueError:
            p.error(f"--seqi needs <in>:<out>: {spec}")
        check_outfile(obase + ".1" + ext, args.force)
        check_outfile(obase + ".2" + ext, args.force)

        def _pairs(path):
            it = seqio.parse_reads(path)
            while True:
                try:
                    r1 = next(it)
                    r2 = next(it)
                except StopIteration:
                    return
                yield r1, r2
        _filter_pairs(_pairs(in1), obase)
    if not (args.seq or args.seq2 or args.seqi):
        p.error("at least one -1/--seq, -2/--seq2 or -i/--seqi required")
    status(f"kept {kept}/{total} reads")
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# coverage (ref ctx_coverage.c)
# ---------------------------------------------------------------------------

_DEGREE_SYMBOLS = [".", "/", "[", "\\", "-", "{", "]", "}", "X"]
_POPC4 = np.array([bin(x).count("1") for x in range(16)])


def cmd_coverage(argv):
    """Per-kmer coverage of each read, one line per colour (edges with
    -e, in/out degree symbols with -E).  The reads of a chunk that pad to
    one length share one lookup, where mctx makes one a read: the text
    is the same."""
    p = argparse.ArgumentParser(prog="mctx-torch coverage")
    p.add_argument("-1", "-s", "--seq", action="append", required=True)
    p.add_argument("-e", "--edges", action="store_true",
                   help="print edges too (hex nibbles)")
    p.add_argument("-E", "--degree", "--degrees", action="store_true",
                   help="print in/out degree per kmer: 00. 01/ 02[ "
                        "10\\ 11- 12{ 20] 21} 22X (ref ctx_coverage -E)")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for parity")
    p.add_argument("ctx", nargs="+")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    from ..io import seqio
    from ..utils import timing
    from ..utils.text import edges_to_strings
    timing.reset()
    h, g = _load_graphs(args.ctx, device)
    k = g.k
    covg = g.covg.cpu().numpy().view(np.uint32)
    edges = g.edges.cpu().numpy()
    out = sys.stdout if args.out == "-" else open(args.out, "w")

    def _write_read(name, n, paths):
        out.write(f">{name}\n")
        if n < k:
            out.write("\n")
            return
        idxn, orn, vn = paths
        npos = n - k + 1
        idxn, orn, vn = idxn[:npos], orn[:npos], vn[:npos]
        rows = np.where(vn, idxn, 0)
        for c in range(h.ncols):
            vals = np.where(vn, covg[rows, c], 0)
            out.write(" ".join(map(str, vals.tolist())) + "\n")
        if args.edges or args.degree:
            e_read = edges[rows]                   # (npos, C)
            # the edge byte along the read (ref fetch_node_edges: the
            # reverse orientation swaps the nibbles)
            rev = orn == 1
            e_or = np.where(rev[:, None],
                            ((e_read >> 4) | (e_read << 4)).astype(np.uint8),
                            e_read)
            e_or = np.where(vn[:, None], e_or, 0)
        if args.edges:
            for c in range(h.ncols):
                estrs = edges_to_strings(e_or[:, c:c + 1])
                out.write(" ".join(
                    estrs[i][0] if vn[i] else "........"
                    for i in range(npos)) + "\n")
        if args.degree:
            for c in range(h.ncols):
                eb = e_or[:, c]
                ind = np.minimum(_POPC4[(eb >> 4) & 0xF], 2)
                outd = np.minimum(_POPC4[eb & 0xF], 2)
                out.write("".join(
                    _DEGREE_SYMBOLS[3 * i_ + o_]
                    for i_, o_ in zip(ind, outd)) + "\n")

    def _chunk(rds):
        seqs = [rd.seq for rd in rds]
        paths = [None] * len(rds)
        rows = [i for i, s in enumerate(seqs) if len(s) >= k]
        with timing.span("lookup", device):
            for idxs, idx, orient, valid in _node_paths_by_length(
                    g, seqs, rows):
                for r, i in enumerate(idxs):
                    paths[i] = (idx[r], orient[r], valid[r])
        with timing.span("write"):
            for rd, pth in zip(rds, paths):
                _write_read(rd.name, len(rd.seq), pth)

    try:
        for path in args.seq:
            for rds in _chunks(seqio.parse_reads(path), _CHUNK):
                _chunk(rds)
    finally:
        if out is not sys.stdout:
            out.close()
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# popbubbles (ref ctx_pop_bubbles.c)
# ---------------------------------------------------------------------------

def cmd_popbubbles(argv):
    p = argparse.ArgumentParser(prog="mctx-torch popbubbles")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-C", "--max-covg", type=int, default=-1,
                   help="only pop if removed branch covg <= this")
    p.add_argument("-L", "--max-len", type=int, default=-1)
    p.add_argument("-D", "--max-diff", type=int, default=-1,
                   help="only pop bubbles whose branch lengths differ "
                        "by at most D kmers (ref ctx_pop_bubbles.c -D)")
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    from ..calls import pop_bubbles as pb
    from ..utils import timing
    timing.reset()
    h, g = _load_graphs(args.ctx, device)
    with timing.span("pop", device):
        g2, npopped = pb.pop_bubbles(g, max_covg=args.max_covg,
                                     max_len=args.max_len,
                                     max_kdiff=args.max_diff)
    status(f"popped {npopped} bubbles: {int(g.n)} -> {int(g2.n)} kmers")
    _save_graph(args.out, h, g2)
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# server (ref ctx_server.c): JSON kmer queries on stdin, replies on stdout
# ---------------------------------------------------------------------------

def cmd_server(argv):
    """One JSON line a query line: 'info', 'random' (in memory) or a kmer.
    In memory, a kmer is looked up through ops/hashidx.lookup (on a
    card the lookup kernel; its table is built once, at start); with
    --disk, through the .ctx file's block index (io/ctx.DiskGraphReader,
    host numpy)."""
    p = argparse.ArgumentParser(prog="mctx-torch server")
    p.add_argument("-p", "--paths", action="append", default=[],
                   help="link files: replies list the kmer's links "
                        "(ref ctx_server.c:194)")
    p.add_argument("-D", "--disk", action="store_true",
                   help="serve from the sorted .ctx on disk through its "
                        ".idx block index (ref ctx_server.c --disk)")
    p.add_argument("-S", "--single-line", action="store_true",
                   help="replies on a single line (always; accepted for "
                        "parity)")
    p.add_argument("-C", "--coverages", action="store_true",
                   help="include per-colour coverages (always included; "
                        "accepted for parity)")
    p.add_argument("-E", "--edges", action="store_true",
                   help="include per-sample edges (always included; "
                        "accepted for parity)")
    p.add_argument("ctx")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    if args.disk and args.paths:
        p.error("--disk serves the graph only (links need in-memory row "
                "resolution); drop -p or --disk")
    from ..io import ctx as ctxio
    if args.disk:
        with ctxio.DiskGraphReader(args.ctx) as dg:
            status(f"server ready (k={dg.h.kmer_size}, {dg.n} kmers, DISK "
                   "mode); enter kmer or 'info'; ctrl-D to quit")
            _serve(dg.h.kmer_size, dg.n, dg.h.ncols, None,
                   lambda key: _disk_reply(dg, key))
        return 0
    h, g = _load_graph(args.ctx, device)
    mem = _MemoryServer(g, args.paths)
    status(f"server ready (k={g.k}, {g.n} kmers); enter kmer, 'info', or "
           "'random'; ctrl-D to quit")
    _serve(g.k, g.n, h.ncols, mem.random_kmer, mem.reply)
    return 0


_BASE_DIGIT = str.maketrans("ACGTacgt", "01230123")
_COMP_DIGIT = str.maketrans("ACGTacgt", "32103210")


def _canonical_key(q: str, W: int) -> np.ndarray:
    """The canonical key ((W,) uint64, word 0 most significant) of a
    kmer string of ACGT: the smaller of the kmer and its reverse
    complement read as base-4 numbers, which is their lexicographic
    order (utils/npkmer.seq_canonical_keys for one kmer)."""
    v = min(int(q.translate(_BASE_DIGIT), 4),
            int(q[::-1].translate(_COMP_DIGIT), 4))
    return np.array([(v >> (64 * (W - 1 - w))) & 0xFFFFFFFFFFFFFFFF
                     for w in range(W)], np.uint64)


def _serve(k, n_kmers, ncols, random_kmer, reply):
    """The query loop: `reply(key)` answers a canonical key ((W,)
    uint64) with the reply's fields after "key", or None when absent;
    `random_kmer` gives a kmer of the graph (None: 'random' is not a
    command, as with --disk)."""
    import json
    from ..constants import nwords
    W = nwords(k)
    for line in sys.stdin:
        q = line.strip()
        if not q:
            continue
        if q == "info":
            print(json.dumps({"kmer_size": k, "num_kmers": n_kmers,
                              "ncols": ncols}))
            continue
        if q == "random" and random_kmer is not None:
            q = random_kmer()
        if len(q) != k or any(c not in "ACGTacgt" for c in q):
            print(json.dumps({"error": f"expected {k}bp kmer"}))
            continue
        fields = reply(_canonical_key(q, W))
        if fields is None:
            print(json.dumps({"key": q, "find": False}))
        else:
            print(json.dumps({"key": q, "find": True, **fields}))
        sys.stdout.flush()


def _disk_reply(dg, key):
    from ..utils.text import edges_to_strings
    hit = dg.lookup(key)
    if hit is None:
        return None
    _row, cv, ed = hit
    return {"colours": [int(c) for c in cv],
            "edges": edges_to_strings(ed[None, :])[0]}


class _MemoryServer:
    """The in-memory graph of `server`: host copies of its coverage and
    edges, the lookup table built once, and the links of -p."""

    def __init__(self, g, link_paths):
        from ..ops import hashidx
        from ..ops import sorted as sops
        self.g = g
        self.covg = g.covg.cpu().numpy().view(np.uint32)
        self.edges = g.edges.cpu().numpy()
        hashidx.lookup(g.keys, sops.sentinel((1,), g.W, g.device))
        self.links = None
        if link_paths:
            from ..io import ctp as ctpio
            links = ctpio.load_link_store(link_paths, g)
            self.links = (links.offsets.cpu().numpy(), links.seq.cpu(),
                          links.nj.cpu().numpy(),
                          links.nseen.cpu().numpy().view(np.uint32))

    def random_kmer(self) -> str:
        from ..utils.text import kmers_to_strings
        row = random.randrange(self.g.n)
        return kmers_to_strings(
            self.g.keys[row:row + 1].cpu().numpy().view(np.uint64),
            self.g.k)[0]

    def reply(self, key):
        from ..ops import hashidx
        from ..utils.text import edges_to_strings
        q = torch.from_numpy(key.view(np.int64)[None]).to(self.g.device)
        row, found = hashidx.lookup(self.g.keys, q)
        r, hit = torch.stack([row.long(), found.long()]).tolist()
        if not hit[0]:
            return None
        r = r[0]
        # union edges -> left/right base lists (ref kmer_response:
        # ctx_server.c:93-106, both uppercased)
        ue = np.bitwise_or.reduce(self.edges[r]).astype(np.uint8)
        ustr = edges_to_strings(np.array([[ue]]))[0][0]
        out = {"colours": [int(c) for c in self.covg[r]],
               "left": "".join(c for c in ustr[:4] if c != ".").upper(),
               "right": "".join(c for c in ustr[4:] if c != "."),
               "edges": edges_to_strings(self.edges[r][None, :])[0]}
        if self.links is not None:
            out["links"] = self._links_of(r)
        return out

    def _links_of(self, row):
        from ..links import store as lstore
        off, seq, nj, nseen = self.links
        out = []
        for o in (0, 1):
            v = 2 * row + o
            for lid in range(int(off[v]), int(off[v + 1])):
                n = int(nj[lid])
                bases = lstore.unpack_junc(seq[[lid] * n], torch.arange(n))
                out.append({"forward": o == 0,
                            "juncs": "".join("ACGT"[b] for b in
                                             bases.tolist()),
                            "colours": [int(x) for x in nseen[lid]]})
        return out


# ---------------------------------------------------------------------------
# exp_abc (hidden; ref ctx_exp_abc.c): traversal-consistency experiment
# ---------------------------------------------------------------------------

def cmd_exp_abc(argv):
    """How often `if A->B and A->B->C then B->C` holds (ref
    ctx_exp_abc.c:14-20): walk from a random node A, take B mid-path and
    C at the end, walk again from B and compare with the A-walk's
    suffix.  The result classes are the reference's RES_* (:52).  Both
    walks are one batched linked walk (links/walk.walk_linked)."""
    p = argparse.ArgumentParser(prog="mctx-torch exp_abc")
    p.add_argument("-p", "--paths", action="append", default=[])
    p.add_argument("-N", "--repeat", type=int, default=2000)
    p.add_argument("-M", "--max-AB-dist", type=int, dest="maxab",
                   default=1000)
    p.add_argument("-P", "--print", dest="print_failed",
                   action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    from ..links import store as lstore
    from ..links import walk as lwalk
    from ..utils.text import kmers_to_strings
    h, g = _load_graph(args.ctx, device)
    links = lstore.empty(g.capacity, g.ncols, device=device)
    if args.paths:
        from ..io import ctp as ctpio
        links = ctpio.load_link_store(args.paths, g)
    rng = np.random.default_rng(args.seed)
    N = args.repeat
    rows = rng.integers(0, int(g.n), N).astype(np.int32)
    orients = rng.integers(0, 2, N).astype(np.uint8)
    cap = min(2 * args.maxab + 2, 4096)

    def walk(r, o):
        st = lwalk.linked_init(g, links, torch.from_numpy(r).to(device),
                               torch.from_numpy(o).to(device), cap)
        st = lwalk.walk_linked(g, links, st, 0, max_steps=cap)
        lwalk.report_drops(st, "exp_abc")
        return st.base.out_vert.cpu().numpy(), st.base.out_len.cpu().numpy()

    pv, pl_ = walk(rows, orients)
    res = {"RES_ABC_SUCCESS": 0, "RES_BC_WRONG": 0,
           "RES_BC_OVERSHOT": 0, "RES_NO_TRAVERSAL": 0,
           "RES_AB_FAILED": 0}
    # B at the midpoint of each A-walk
    bsel = []
    for i in range(N):
        if pl_[i] < 2:
            res["RES_AB_FAILED"] += 1
            continue
        bsel.append((i, min(args.maxab, int(pl_[i]) // 2)))
    if bsel:
        bv = np.array([pv[i, m - 1] for i, m in bsel])
        qv, ql = walk((bv >> 1).astype(np.int32), (bv & 1).astype(np.uint8))
        keys_np = None
        for j, (i, mid) in enumerate(bsel):
            want = pv[i, mid:pl_[i]]
            got = qv[j, :ql[j]]
            nw_ = len(want)
            if ql[j] == 0 and nw_ > 0:
                res["RES_NO_TRAVERSAL"] += 1
            elif len(got) >= nw_ and (got[:nw_] == want).all():
                if len(got) > nw_:
                    res["RES_BC_OVERSHOT"] += 1
                else:
                    res["RES_ABC_SUCCESS"] += 1
            else:
                res["RES_BC_WRONG"] += 1
                if args.print_failed:
                    if keys_np is None:
                        keys_np = g.keys.cpu().numpy().view(np.uint64)
                    krow = pv[i, mid - 1] >> 1
                    ks = kmers_to_strings(keys_np[krow:krow + 1], g.k)[0]
                    print(f">failed_B_{i}\n{ks}")
    total = max(N, 1)
    for name, cnt in res.items():
        status(f"{name}: {cnt} / {N} ({100.0 * cnt / total:.2f}%)")
    return 0

"""mctx-torch subcommands (counterpart of mccortex_tpu/cli/commands.py).

Ported so far: build (all of `mctx build` on one device except --ref and
SAM/BAM/CRAM input), clean, unitigs.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..utils import timing
from .common import (add_common, apply_common, check_kmer, devices_arg,
                     nkmers_hint)

def _not_ported(p, flag: str):
    p.error(f"{flag} is not yet ported to mctx-torch (use mctx)")


def cmd_build(argv):
    p = argparse.ArgumentParser(
        prog="mctx-torch build",
        description="reads -> coloured .ctx graph",
        epilog="colour tasks (order on the command line defines the "
               "colours): -s/--sample <name> starts a colour; "
               "-1/--seq <in>, -2/--seq2 <in1>:<in2> (or two args), "
               "-i/--seqi <interleaved> add that colour's reads (FASTA or "
               "FASTQ, plain or gz); -g/--graph <in.ctx> slots an existing "
               "graph's colours in at its position.  The sort engine is "
               "the environment variable MCTX_SORT: lax (default), lax64, "
               "mp, bitonic")
    p.add_argument("-k", "--kmer", type=int, required=True)
    p.add_argument("-Q", "--fq-cutoff", type=int, default=0)
    p.add_argument("-O", "--fq-offset", type=int, default=0,
                   help="FASTQ quality ASCII offset: 33 or 64 "
                        "[default: 0 = auto-detect per file]")
    p.add_argument("-H", "--cut-hp", type=int, default=0)
    p.add_argument("-M", "--matepair", default="FR",
                   choices=["FF", "FR", "RF", "RR"],
                   help="mate pair orientation for --seq2/--seqi "
                        "PCR-duplicate detection")
    p.add_argument("-p", "--remove-pcr", action="store_true",
                   help="drop reads whose start kmers were already seen "
                        "as read starts (PCR duplicate removal)")
    p.add_argument("-P", "--keep-pcr", action="store_true",
                   help="no PCR duplicate removal (default)")
    p.add_argument("--sort", action="store_true",
                   help="sort output kmers (accepted for parity: the "
                        "store is always sorted)")
    p.add_argument("-I", "--intersect", default=None,
                   help="only keep kmers also present in this graph")
    p.add_argument("--ref", default=None, help="not yet ported")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for parity")
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("-o", "--out", dest="out_explicit", default=None)
    p.add_argument("out", nargs="?", default=None)
    add_common(p, memory=True, nkmers=True)
    args, tasks = _parse_build_tasks(p, argv)
    if args.ref:
        _not_ported(p, "--ref")
    out = args.out_explicit or args.out
    if not out:
        p.error("output .ctx path required")
    if not tasks:
        p.error("at least one --sample ... --seq ... required")
    if args.fq_offset not in (0, 33, 64):
        p.error("--fq-offset must be 33 or 64 (0 = auto)")
    if args.keep_pcr and args.remove_pcr:
        p.error("--keep-pcr conflicts with --remove-pcr")
    k = check_kmer(args.kmer, p)
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
    status, device = apply_common(args, out)

    from ..constants import nwords
    from ..graph import build as gbuild
    from ..graph import store as gstore
    from ..io import ctx as ctxio
    from ..io import seqio
    from ..ops import sorted as sops
    from ..utils import membudget as mb

    def _mask(codes, quals):
        if quals is not None and args.fq_cutoff:
            return gbuild.mask_reads(
                torch.from_numpy(codes), torch.from_numpy(quals),
                fq_cutoff=args.fq_cutoff, hp_cutoff=args.cut_hp).numpy()
        if args.cut_hp:
            return gbuild.mask_reads(torch.from_numpy(codes), None,
                                     hp_cutoff=args.cut_hp).numpy()
        return codes

    ginfo = []
    batches = []
    gmerge = []   # (colour offset, keys, covg, edges) from --graph files
    pcr = gbuild.PcrDupFilter(k, device) if args.remove_pcr else None
    ndup = 0
    colour = 0
    t0 = time.perf_counter()
    for task in tasks:
        if task[0] == "graph":
            h2, k2, c2, e2 = ctxio.read_ctx(task[1])
            if h2.kmer_size != k:
                p.error(f"--graph {task[1]}: kmer size "
                        f"{h2.kmer_size} != {k}")
            gmerge.append((colour, k2, c2, e2))
            ginfo.extend(h2.ginfo)
            status(f"colour {colour}..{colour + h2.ncols - 1}: graph "
                   f"{task[1]} ({len(k2)} kmers)")
            colour += h2.ncols
            continue
        _, sample, files = task
        total_seq = 0
        nreads = 0

        def _emit(codes, quals):
            nonlocal total_seq, nreads
            codes = _mask(np.ascontiguousarray(codes), quals)
            total_seq += int((codes < 4).sum())
            nreads += codes.shape[0]
            batches.append((codes, colour))

        def _keep(c1, c2, *quals):
            """Apply the PCR filter to one batch (a pair when c2 is
            given); returns the kept rows of every array, or None when
            none is left."""
            nonlocal ndup
            if pcr is None:
                return (c1, c2) + quals
            keepm = pcr.filter_batch(c1, c2)
            ndup += int((~keepm).sum()) * (1 if c2 is None else 2)
            if not keepm.any():
                return None
            return tuple(None if x is None else x[keepm]
                         for x in (c1, c2) + quals)

        for entry in files:
            kind = entry[0]
            if kind == "se":
                for codes, quals, _ in seqio.read_batches_chunked(
                        [entry[1]], colour=colour, overlap=k,
                        fq_offset=args.fq_offset):
                    kept = _keep(codes, None, quals)
                    if kept is not None:
                        _emit(kept[0], kept[2])
            elif kind == "pe":
                # a pair is dropped only when both mates' start kmers
                # were seen
                for c1, c2, _ in seqio.read_batches_pe(
                        entry[1], entry[2], colour=colour,
                        matedir=args.matepair, fq_offset=args.fq_offset):
                    kept = _keep(c1, c2)
                    if kept is not None:
                        _emit(kept[0], None)
                        _emit(kept[1], None)
            else:   # interleaved: even rows = r1, odd rows = r2
                for c1, c2, q1, q2, _ in seqio.read_batches_interleaved(
                        entry[1], colour=colour, matedir=args.matepair,
                        fq_offset=args.fq_offset):
                    kept = _keep(c1, c2, q1, q2)
                    if kept is not None:
                        _emit(kept[0], kept[2])
                        _emit(kept[1], kept[3])
        ginfo.append(ctxio.GraphInfo(
            sample_name=sample, total_sequence=total_seq,
            mean_read_length=total_seq // max(nreads, 1)))
        status(f"colour {colour} '{sample}': {nreads} reads, "
               f"{total_seq} bases")
        colour += 1
    ncols = colour
    status(f"read {len(batches)} batches in {time.perf_counter() - t0:.3f}s")
    if args.remove_pcr:
        status(f"removed {ndup} PCR duplicate reads")
    budget = None
    if args.memory:
        budget = mb.parse_mem(args.memory)
        cap = mb.kmers_in_budget(budget, nwords(k), ncols)
        dmem = mb.device_mem_bytes(device)
        on_dev = f" (device memory {mb.mem_str(dmem)})" if dmem else ""
        status(f"memory budget {mb.mem_str(budget)}{on_dev}: up to {cap} "
               f"kmers")

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    t0 = time.perf_counter()
    g = gbuild.build(batches, k, ncols=ncols, device=device,
                     capacity=nkmers_hint(args))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    status(f"built {g.n} kmers from {len(batches)} batches in "
           f"{time.perf_counter() - t0:.3f}s on {where} "
           f"(sort engine {gbuild.SORT_IMPL})")
    if gmerge:
        g = _store_from_host_records(
            k, [(0,) + gstore.to_host(g)] + gmerge, ncols, device)
    if args.intersect:
        hi_, ikeys, _ic, _ie = ctxio.read_ctx(args.intersect)
        if hi_.kmer_size != k:
            p.error(f"--intersect kmer size {hi_.kmer_size} != {k}")
        if len(ikeys):
            _idx, found = sops.lookup(
                torch.from_numpy(ikeys.view(np.int64)).to(device), g.keys)
            keep = found & ~sops.is_sentinel(g.keys)
        else:
            keep = torch.zeros(g.capacity, dtype=torch.bool, device=device)
        g = gstore.from_records(k, g.keys[keep], g.covg[keep], g.edges[keep])
        for gi in ginfo:
            gi.cleaning.is_graph_intersection = True
            gi.cleaning.intersection_name = args.intersect
        status(f"intersected with {args.intersect}: {g.n} kmers")
    if budget is not None:
        status(mb.check_plan(budget, mb.graph_mem_bytes(g.n, nwords(k),
                                                        ncols)))
    t0 = time.perf_counter()
    keys, covg, edges = gstore.to_host(g)
    hdr = ctxio.CtxHeader(kmer_size=k, ginfo=ginfo)
    ctxio.write_ctx(out, hdr, keys, covg, edges)
    status(f"wrote {len(keys)} kmers x {ncols} colours to {out} in "
           f"{time.perf_counter() - t0:.3f}s")
    return 0


def _store_from_host_records(k, parts, ncols, device):
    """Store of ncols colours on `device` from host record sets: each part
    is (colour offset, uint64 keys, uint32 covg, uint8 edges) and fills
    the colours from its offset on; equal keys are aggregated."""
    from ..graph import store as gstore
    allk, allc, alle = [], [], []
    for off, keys, covg, edges in parts:
        cw = np.zeros((len(keys), ncols), np.uint32)
        ew = np.zeros((len(keys), ncols), np.uint8)
        cw[:, off:off + covg.shape[1]] = covg
        ew[:, off:off + edges.shape[1]] = edges
        allk.append(keys)
        allc.append(cw)
        alle.append(ew)
    return gstore.from_records(
        k, torch.from_numpy(np.concatenate(allk).view(np.int64)).to(device),
        torch.from_numpy(np.concatenate(allc).view(np.int32)).to(device),
        torch.from_numpy(np.concatenate(alle)).to(device))


# ---------------------------------------------------------------------------
# clean and unitigs (ref: src/commands/ctx_clean.c, ctx_unitigs.c)
# ---------------------------------------------------------------------------

def _load_graph(path, device):
    """Load a .ctx file into a store on `device`."""
    from ..graph import store as gstore
    from ..io import ctx as ctxio
    h, keys, covg, edges = ctxio.read_ctx(path)
    if len(keys) == 0:
        return h, gstore.empty(h.kmer_size, 1, h.ncols, device)
    return h, gstore.from_host(keys, covg, edges, h.kmer_size, device)


def _load_graphs(paths, device):
    """Load one or more .ctx files into a single store, colours
    concatenated in command-line order (records merged with
    store.from_records on `device`)."""
    with timing.span("load", device):
        if len(paths) == 1:
            return _load_graph(paths[0], device)
        from ..graph import store as gstore
        from ..io import ctx as ctxio
        loaded = [ctxio.read_ctx(p) for p in paths]
        k = loaded[0][0].kmer_size
        for (h, *_), p in zip(loaded, paths):
            if h.kmer_size != k:
                raise ValueError(f"{p}: kmer size {h.kmer_size} != {k}")
        ncols = sum(h.ncols for h, *_ in loaded)
        parts, ginfo = [], []
        off = 0
        for h, keys, covg, edges in loaded:
            parts.append((off, keys, covg, edges))
            ginfo.extend(h.ginfo)
            off += h.ncols
        g = _store_from_host_records(k, parts, ncols, device)
        return ctxio.CtxHeader(kmer_size=k, ginfo=ginfo), g


def _save_graph(path, h, g):
    from ..graph import store as gstore
    from ..io import ctx as ctxio
    with timing.span("write"):
        keys, covg, edges = gstore.to_host(g)
        ctxio.write_ctx(path, h, keys, covg, edges)


def cmd_clean(argv):
    p = argparse.ArgumentParser(prog="mctx-torch clean")
    p.add_argument("-T", "--tips", type=int, default=0, nargs="?",
                   const=-1,
                   help="clip tips shorter than this (default 2k)")
    p.add_argument("-U", "--unitigs", type=int, default=0, nargs="?",
                   const=-1,
                   help="remove unitigs below covg threshold (default auto)")
    p.add_argument("-B", "--fallback", type=int, default=0,
                   help="threshold to use if auto-detection fails")
    p.add_argument("-N", "--ncols", type=int, default=None,
                   help="colours to process at once (accepted for parity: "
                        "the store processes all colours in one pass)")
    p.add_argument("-S", "--sort", action="store_true",
                   help="output sorted by kmer (always true here: the "
                        "store is sorted)")
    p.add_argument("-c", "--covg-before", default=None,
                   help="save kmer/unitig coverage histogram CSV before "
                        "cleaning")
    p.add_argument("-C", "--covg-after", default=None,
                   help="coverage histogram CSV after cleaning")
    p.add_argument("-l", "--len-before", default=None,
                   help="unitig length histogram CSV before cleaning")
    p.add_argument("-L", "--len-after", default=None,
                   help="unitig length histogram CSV after cleaning")
    p.add_argument("-m", "--memory", default=None, help="not yet ported")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    if args.memory:
        _not_ported(p, "-m/--memory")
    status, device = apply_common(args, args.out, args.covg_before,
                                  args.covg_after, args.len_before,
                                  args.len_after)
    timing.SPANS.clear()
    from ..graph import clean as gclean
    h, g = _load_graphs(args.ctx, device)
    k = h.kmer_size

    if args.covg_before or args.len_before:
        kh, uh, lh = gclean.cleaning_histograms(g)
        if args.covg_before:
            gclean.write_covg_csv(args.covg_before, kh, uh)
            status(f"saved coverage histogram: {args.covg_before}")
        if args.len_before:
            gclean.write_len_csv(args.len_before, lh, k)
            status(f"saved length histogram: {args.len_before}")

    tips = (2 * k) if args.tips == -1 else args.tips
    thresh = args.unitigs
    if thresh == -1:  # auto threshold from histogram fit
        hist = gclean.covg_histogram(g)
        cutoff, a, b, fp, fn = gclean.pick_kmer_threshold(hist)
        if cutoff < 0:
            if args.fallback > 0:
                cutoff = args.fallback
                status(f"auto threshold failed; using fallback {cutoff}")
            else:
                p.error("could not pick cleaning threshold "
                        "(use --fallback <T>)")
        else:
            status(f"auto cleaning threshold: <{cutoff} "
                   f"(alpha={a:.2f} beta={b:.2f} fp={fp:.4f} fn={fn:.4f})")
        thresh = cutoff

    before = g.n
    g2 = gclean.clean_graph(g, covg_threshold=max(thresh, 0),
                            min_keep_tip=tips)
    status(f"cleaned: {before} -> {g2.n} kmers "
           f"(tips<{tips}, covg<{thresh})")
    if args.covg_after or args.len_after:
        kh, uh, lh = gclean.cleaning_histograms(g2)
        if args.covg_after:
            gclean.write_covg_csv(args.covg_after, kh, uh)
            status(f"saved coverage histogram: {args.covg_after}")
        if args.len_after:
            gclean.write_len_csv(args.len_after, lh, k)
            status(f"saved length histogram: {args.len_after}")
    for gi in h.ginfo:
        if tips:
            gi.cleaning.cleaned_tips = True
        if thresh > 0:
            gi.cleaning.cleaned_unitigs = True
            gi.cleaning.clean_unitigs_thresh = max(thresh, 0)
    _save_graph(args.out, h, g2)
    status(f"time split: {timing.summary()}")
    return 0


def cmd_unitigs(argv):
    p = argparse.ArgumentParser(prog="mctx-torch unitigs")
    p.add_argument("-F", "--fasta", action="store_true",
                   help="FASTA output (default)")
    p.add_argument("-g", "--gfa", action="store_true",
                   help="GFA v1 output")
    p.add_argument("-d", "--dot", "--graphviz", action="store_true",
                   help="graphviz output")
    p.add_argument("-P", "--point", "--points", action="store_true",
                   help="with --dot, print unitigs as points")
    p.add_argument("--min-len", type=int, default=0,
                   help="minimum unitig length in bases")
    p.add_argument("-o", "--out", default="-",
                   help="output file [default: STDOUT]")
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    timing.SPANS.clear()
    from ..graph import unitigs as gu
    h, g = _load_graphs(args.ctx, device)
    seqs = gu.extract_unitigs(g)
    seqs = [s for s in seqs if len(s) >= args.min_len]
    with timing.span("write"):
        fh = sys.stdout if args.out == "-" else open(args.out, "w")
        try:
            if args.gfa or args.dot:
                from ..graph import unitig_graph as ug
                if args.gfa:
                    ug.write_gfa(fh, g, seqs)
                else:
                    ug.write_dot(fh, g, seqs, points=args.point)
            else:
                for i, s in enumerate(seqs):
                    fh.write(f">unitig{i} length={len(s)}\n{s}\n")
        finally:
            if fh is not sys.stdout:
                fh.close()
    status(f"{len(seqs)} unitigs of {g.n} kmers")
    status(f"time split: {timing.summary()}")
    return 0


def _parse_build_tasks(p, argv):
    """Pair each --sample with the sequence inputs that follow it, in
    command-line order; -g/--graph slots an existing .ctx file's colours
    in at its position.  Every other argument goes to the parser.
    Returns (args, tasks), a task being ("sample", name, inputs) or
    ("graph", path) and an input ("se", path), ("pe", path1, path2) or
    ("interleaved", path)."""
    tasks = []
    cur_name, cur_files = None, []
    rest = []
    i = 0

    def flush():
        nonlocal cur_name, cur_files
        if cur_name is not None:
            tasks.append(("sample", cur_name, cur_files))
        cur_name, cur_files = None, []

    def operands(n):
        vals = argv[i + 1:i + 1 + n]
        if len(vals) < n:
            p.error(f"{argv[i]} needs {n} argument{'s' if n > 1 else ''}")
        return vals

    def add_input(entry):
        if cur_name is None:
            p.error(f"{argv[i]} {entry[1]}: give --sample first")
        cur_files.append(entry)

    while i < len(argv):
        a = argv[i]
        if a in ("-s", "--sample"):
            name, = operands(1)
            flush()
            cur_name, cur_files = name, []
            i += 2
        elif a in ("-1", "--seq", "--seq1"):
            add_input(("se",) + tuple(operands(1)))
            i += 2
        elif a in ("-2", "--seq2"):
            first, = operands(1)
            if ":" in first:       # "in1:in2", or two separate arguments
                add_input(("pe",) + tuple(first.split(":", 1)))
                i += 2
            else:
                add_input(("pe",) + tuple(operands(2)))
                i += 3
        elif a in ("-i", "--seqi"):
            add_input(("interleaved",) + tuple(operands(1)))
            i += 2
        elif a in ("-g", "--graph"):
            path, = operands(1)
            flush()
            tasks.append(("graph", path))
            i += 2
        else:
            rest.append(a)
            i += 1
    flush()
    return p.parse_args(rest), tasks

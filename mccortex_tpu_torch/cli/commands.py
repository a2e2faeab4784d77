"""mctx-torch subcommands (counterpart of mccortex_tpu/cli/commands.py):
build (all of `mctx build` on one device), view, check (with -p),
clean, unitigs, inferedges, contigs (linkless and linked), pview,
thread (single-end and paired) and bubbles.  The commands of
mccortex_tpu/cli/commands2.py and commands3.py are in commands2.py and
commands3.py.
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
               "-i/--seqi <interleaved> add that colour's reads (FASTA, "
               "FASTQ, SAM, BAM or CRAM, plain or gz); -g/--graph <in.ctx> "
               "slots an existing graph's colours in at its position.  The "
               "sort engine is the environment variable MCTX_SORT: lax "
               "(default), lax64, mp, bitonic")
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
    p.add_argument("--ref", default=None,
                   help="reference FASTA that mapped CRAM records are "
                        "rebuilt against (unmapped CRAMs and CRAMs with "
                        "an embedded reference need none)")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for parity")
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("-o", "--out", dest="out_explicit", default=None)
    p.add_argument("out", nargs="?", default=None)
    add_common(p, memory=True, nkmers=True)
    args, tasks = _parse_build_tasks(p, argv)
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
    from ..utils import membudget as mb

    cram_ref = None
    if args.ref:
        from ..graph.kmer_occur import RefGenome
        cram_ref = RefGenome.from_fasta(args.ref).as_dict()
    reader = dict(fq_offset=args.fq_offset, cram_ref=cram_ref)

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
                for codes, quals, _ in seqio.read_batches_native(
                        [entry[1]], colour=colour, overlap=k, **reader):
                    kept = _keep(codes, None, quals)
                    if kept is not None:
                        _emit(kept[0], kept[2])
            elif kind == "pe":
                # a pair is dropped only when both mates' start kmers
                # were seen
                for c1, c2, _ in seqio.read_batches_pe(
                        entry[1], entry[2], colour=colour,
                        matedir=args.matepair, **reader):
                    kept = _keep(c1, c2)
                    if kept is not None:
                        _emit(kept[0], None)
                        _emit(kept[1], None)
            else:   # interleaved: even rows = r1, odd rows = r2
                for c1, c2, q1, q2, _ in seqio.read_batches_interleaved(
                        entry[1], colour=colour, matedir=args.matepair,
                        **reader):
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
    status(f"read {len(batches)} batches in {time.perf_counter() - t0:.3f}s "
           f"({seqio.reader_name()} reader)")
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
        g = intersect_store(g, ikeys)
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


def intersect_store(g, ikeys):
    """The store's records whose kmer is among `ikeys` (uint64 (M, W),
    another graph's keys), as a store on the same device.  The store's
    kmers are looked up in a table of `ikeys` (ops/hashidx.lookup: the
    lookup kernel on the card)."""
    from ..graph import store as gstore
    from ..ops import hashidx
    from ..ops import sorted as sops
    if len(ikeys):
        table_keys = torch.from_numpy(
            np.ascontiguousarray(ikeys).view(np.int64)).to(g.device)
        _idx, found = hashidx.lookup(table_keys, g.keys)
        keep = found & ~sops.is_sentinel(g.keys)
    else:
        keep = torch.zeros(g.capacity, dtype=torch.bool, device=g.device)
    return gstore.from_records(g.k, g.keys[keep], g.covg[keep],
                               g.edges[keep])


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
# view and check
# ---------------------------------------------------------------------------

def cmd_view(argv):
    p = argparse.ArgumentParser(prog="mctx-torch view")
    p.add_argument("-k", "--kmers", action="store_true",
                   help="print every kmer with its coverages and edges")
    p.add_argument("-i", "--info", action="store_true",
                   help="print the header")
    p.add_argument("-c", "--check", action="store_true",
                   help="check the graph's integrity")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    if not (args.kmers or args.info or args.check):
        args.info = args.check = True

    from ..io import ctx as ctxio
    h, keys, covg, edges = ctxio.read_ctx(args.ctx)
    if args.info:
        print(f"version: {h.version}")
        print(f"kmer size: {h.kmer_size}")
        print(f"bitfields: {h.W}")
        print(f"colours: {h.ncols}")
        print(f"number of kmers: {len(keys)}")
        for i, gi in enumerate(h.ginfo):
            print(f"Colour {i}:")
            print(f"  sample name: '{gi.sample_name}'")
            print(f"  mean input contig length: {gi.mean_read_length}")
            print(f"  total sequence loaded:    {gi.total_sequence}")
    if args.kmers:
        _print_kmers(h, keys, covg, edges)
    if args.check:
        errs = check_graph_arrays(h.kmer_size, keys, covg, edges, device)
        for e in errs:
            print(f"check: {e}", file=sys.stderr)
        if errs:
            return 1
        status("graph check passed")
    return 0


def _print_kmers(h, keys, covg, edges, out=None):
    """Text dump, a line a kmer: '<kmer> <covg...> <edges...>'."""
    out = out or sys.stdout
    from ..utils.text import edges_to_strings, kmers_to_strings
    kstrs = kmers_to_strings(keys, h.kmer_size)
    estrs = edges_to_strings(edges)
    for i in range(len(keys)):
        cov = " ".join(str(c) for c in covg[i].tolist())
        out.write(f"{kstrs[i]} {cov} {' '.join(estrs[i])}\n")


def check_graph_arrays(k, keys, covg, edges, device) -> list:
    """Structural checks of host records (keys (N, W) uint64, covg (N, C)
    uint32, edges (N, C) uint8), run on `device`: sorted unique keys,
    canonical keys, no kmer without coverage, edge symmetry."""
    from ..utils import checks
    return checks.check_graph_arrays(
        k, torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)
                            ).to(device),
        torch.from_numpy(np.ascontiguousarray(covg).view(np.int32)
                         ).to(device),
        torch.from_numpy(np.ascontiguousarray(edges)).to(device))


def cmd_check(argv):
    p = argparse.ArgumentParser(prog="mctx-torch check")
    p.add_argument("-p", "--paths", action="append", default=[],
                   help="link files to verify against the graph: every "
                        "link must be walkable in each colour it is seen "
                        "in (ref ctx_health_check.c: "
                        "gpath_checks_all_paths)")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    from ..io import ctx as ctxio
    h, keys, covg, edges = ctxio.read_ctx(args.ctx)
    errs = check_graph_arrays(h.kmer_size, keys, covg, edges, device)
    for e in errs:
        print(f"check: {e}", file=sys.stderr)
    if errs:
        return 1
    status(f"{args.ctx}: OK ({len(keys)} kmers, {h.ncols} colours)")
    if args.paths:
        from ..io import ctp as ctpio
        from ..links import check as lcheck
        _h, g = _load_graph(args.ctx, device)
        links = ctpio.load_link_store(args.paths, g)
        nchecked, nbad, bad_ids = lcheck.check_links(g, links)
        if nbad:
            print(f"check: {nbad}/{nchecked} link walks FAILED "
                  f"(link ids {bad_ids[:10].tolist()}...)",
                  file=sys.stderr)
            return 1
        status(f"links OK ({links.nlinks} links, "
               f"{nchecked} colour-walks verified)")
    return 0


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
    p.add_argument("-o", "--out", required=True)
    p.add_argument("ctx", nargs="+")
    add_common(p, memory=True)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out, args.covg_before,
                                  args.covg_after, args.len_before,
                                  args.len_after)
    timing.SPANS.clear()
    from ..graph import clean as gclean
    h, g = _load_graphs(args.ctx, device)
    k = h.kmer_size
    if args.memory:
        from ..utils import membudget as mb
        status(mb.check_plan(mb.parse_mem(args.memory),
                             mb.graph_mem_bytes(g.capacity, h.W, h.ncols)))

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


# ---------------------------------------------------------------------------
# inferedges (ref: src/commands/ctx_infer_edges.c)
# ---------------------------------------------------------------------------

def cmd_inferedges(argv):
    p = argparse.ArgumentParser(prog="mctx-torch inferedges")
    g1 = p.add_mutually_exclusive_group()
    g1.add_argument("--pop", action="store_true", default=True)
    g1.add_argument("--all", dest="all_edges", action="store_true")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    timing.SPANS.clear()
    from ..graph import infer_edges as ie
    h, g = _load_graphs([args.ctx], device)
    g2 = ie.infer_edges(g, pop_only=not args.all_edges)
    added = int((g2.edges != g.edges).sum())
    status(f"inferred edges: {added} edge bytes changed")
    _save_graph(args.out, h, g2)
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# contigs (ref: src/commands/ctx_contigs.c), linkless or linked
# ---------------------------------------------------------------------------

def cmd_contigs(argv):
    p = argparse.ArgumentParser(prog="mctx-torch contigs")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-c", "--colour", type=int, default=0)
    p.add_argument("-N", "--ncontigs", type=int, default=0,
                   help="pull out at most N contigs "
                        "[default: 0 = no limit] (ref ctx_contigs.c -N)")
    g1 = p.add_mutually_exclusive_group()
    g1.add_argument("-r", "--reseed", dest="reseed", action="store_true",
                    help="sample seed kmers with replacement")
    g1.add_argument("-R", "--no-reseed", dest="reseed",
                    action="store_false",
                    help="do not reuse seed kmers already in a contig "
                         "[default, ref ctx_contigs.c:29]")
    p.set_defaults(reseed=False)
    p.add_argument("-s", "--seed", action="append", default=[],
                   help="seed kmers from a FASTA (reads must be kmer "
                        "length, ref ctx_contigs.c:27)")
    p.add_argument("-P", "--use-seed-paths", action="store_true",
                   help="seed contigs from unused links "
                        "(ref ctx_contigs.c:30; with -p)")
    p.add_argument("--max-len", type=int, default=65536,
                   help="max contig extension per direction (kmers)")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("-G", "--genome", type=int, default=0,
                   help="genome size (bases) for NG50 + confidence table")
    p.add_argument("-C", "--confid-cumul", type=float, default=-1.0,
                   help="halt when cumulative confidence < C "
                        "(ref ctx_contigs.c:32; needs -p)")
    p.add_argument("-T", "--confid-step", type=float, default=-1.0,
                   help="halt when single-step confidence < C "
                        "(ref ctx_contigs.c:33; needs -p)")
    p.add_argument("-S", "--confid-csv", default=None,
                   help="save the confidence table as CSV")
    p.add_argument("-p", "--paths", action="append", default=[],
                   help=".ctp link files (link-guided assembly)")
    p.add_argument("-M", "--no-missing-check", dest="missing_check",
                   action="store_false", default=True,
                   help="disable the missing-link-information halt "
                        "(ref contigs default: check enabled)")
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(argv)
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
    status, device = apply_common(args, args.out, args.confid_csv)
    timing.SPANS.clear()
    from ..graph import traverse as T
    from ..utils.stats import contig_stats
    h, g = _load_graphs([args.ctx], device)
    n = g.n

    links = None
    if args.paths:
        from ..io import ctp as ctpio
        with timing.span("links", device):
            links = ctpio.load_link_store(args.paths, g)

    # confidence table from the genome size and the .ctp contig-length
    # histograms (ref ctx_contigs.c:225-239 conf_table_update_hist)
    conf_arr = None
    if args.confid_cumul >= 0 or args.confid_step >= 0 or args.confid_csv:
        if not args.genome:
            p.error("--confid-* / --confid-csv require --genome")
        from ..graph import contig_confidence as cc
        from ..io import ctp as ctpio
        hist = {}
        for pth in args.paths:
            ph = ctpio.load_ctp_header(pth)
            for lng, cnt in ctpio.contig_hist_from_header(
                    ph, args.colour).items():
                hist[lng] = hist.get(lng, 0) + cnt
        table = cc.conf_table(args.genome, hist)
        if args.confid_csv:
            with open(args.confid_csv, "w") as fh:
                cc.print_table(table, fh)
            status(f"saved confidence table -> {args.confid_csv}")
        if links is None and (args.confid_cumul >= 0 or
                              args.confid_step >= 0):
            p.error("--confid-* need -p link files")
        conf_arr = torch.from_numpy(table.astype(np.float32)).to(device)

    seed_rows = None
    if args.seed:
        seed_rows = _seed_rows(g, args.seed, status)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    visited = np.zeros(n, dtype=bool)
    lengths = []
    stop_counts = np.zeros(len(T.STATUS_STR), np.int64)
    ncontig = 0
    batch = args.batch
    order = seed_rows if seed_rows is not None else np.arange(n)
    if args.ncontigs > 0 and seed_rows is None:
        # ref -N: pull contigs from random kmers
        order = np.random.default_rng(0).permutation(n)
    used_links = (np.zeros(links.nlinks, bool)
                  if links is not None else None)
    conf_kw = dict(conf_table=conf_arr, min_step=args.confid_step,
                   min_cumul=args.confid_cumul)
    for s0 in range(0, len(order), batch):
        if args.ncontigs > 0 and ncontig >= args.ncontigs:
            break
        seeds = order[s0:s0 + batch]
        if not args.reseed:
            seeds = seeds[~visited[seeds]]
        if len(seeds) == 0:
            continue
        extra = None
        if links is not None:
            from ..links import walk as lwalk
            contigs, stats, extra = lwalk.assemble_contigs_primed(
                g, links, seeds, colour=args.colour, max_len=args.max_len,
                missing_check=args.missing_check,
                track_used=args.use_seed_paths, return_extra=True,
                **conf_kw)
            if args.use_seed_paths:
                used_links |= extra["used"]
        else:
            contigs, stats = T.assemble_linkless_contigs(
                g, seeds, colour=args.colour, max_len=args.max_len)
        for i, c in enumerate(contigs):
            if args.ncontigs > 0 and ncontig >= args.ncontigs:
                break
            if not args.reseed:
                # a later seed of this batch may already be covered by an
                # earlier contig (the reference checks seed by seed,
                # assemble_contigs.c:223)
                if visited[int(seeds[i])]:
                    continue
                with timing.span("mark", device):
                    _mark_contig_kmers(g, c, visited)
            hdr = f">contig{ncontig} length={len(c)} seed={int(seeds[i])}"
            if extra is not None and conf_arr is not None:
                hdr += (f" lf.conf={extra['cum_conf'][i, 1]:.5f}"
                        f" lf.max_gap={int(extra['max_gap'][i, 1])}"
                        f" rt.conf={extra['cum_conf'][i, 0]:.5f}"
                        f" rt.max_gap={int(extra['max_gap'][i, 0])}")
            with timing.span("write"):
                out.write(f"{hdr}\n{c}\n")
            lengths.append(len(c))
            # both directions' halt reasons (ref assemble_stats
            # stop_causes table)
            for s_ in np.asarray(stats[i]).reshape(-1):
                stop_counts[int(s_) % len(T.STATUS_STR)] += 1
            ncontig += 1

    # second pass: seed from links never followed to their end in a
    # contig (ref assemble_contigs.c _assemble_from_paths)
    if args.use_seed_paths and links is not None:
        from ..links import walk as lwalk
        has_col = links.nseen[:, args.colour].cpu().numpy() != 0
        unused = np.nonzero(has_col & ~used_links)[0]
        status(f"contigs: seeding from {len(unused)} unused links")
        for s0 in range(0, len(unused), batch):
            lids = unused[s0:s0 + batch]
            contigs, stats = lwalk.assemble_contigs_from_paths(
                g, links, lids, colour=args.colour, max_len=args.max_len,
                missing_check=args.missing_check, **conf_kw)
            for i, c in enumerate(contigs):
                out.write(f">contig{ncontig} length={len(c)} "
                          f"seedpath={int(lids[i])}\n{c}\n")
                lengths.append(len(c))
                ncontig += 1
    if out is not sys.stdout:
        out.close()
    st = contig_stats(lengths, genome_size=args.genome or None)
    status(f"contigs: {st['n']} total={st['total']} max={st['max']} "
           f"N50={st['n50']} NG50={st['ng50']}")
    if stop_counts.sum():
        # halt-reason table (ref assemble_stats.c stop_causes)
        parts = [f"{T.STATUS_STR[i]}={int(c)}"
                 for i, c in enumerate(stop_counts) if c]
        status("contigs halt reasons: " + " ".join(parts))
    status(f"time split: {timing.summary()}")
    return 0


def _seed_rows(g, paths, status) -> np.ndarray:
    """Store rows of the kmer-length reads of `paths` (-s/--seed)."""
    from ..io import seqio
    from ..ops import kmer as kops
    from ..ops import sorted as sops
    found_rows = []
    nmiss = 0
    for codes, _, _ in seqio.read_batches(paths):
        if codes.shape[1] != g.k:
            raise SystemExit(
                f"--seed reads must be kmer length ({g.k}): "
                f"got {codes.shape[1]}")
        kk = kops.pack_kmers(torch.from_numpy(codes).to(g.device), g.k)
        keys, _ = kops.canonical(kk, g.k)
        idx, fnd = sops.lookup(g.keys, keys)
        fnd = fnd.cpu().numpy()
        found_rows.append(idx.cpu().numpy()[fnd])
        nmiss += int((~fnd).sum())
    if nmiss:
        status(f"contigs: {nmiss} seed kmers not found in graph")
    return (np.concatenate(found_rows) if found_rows
            else np.zeros(0, np.int64))


def _mark_contig_kmers(g, contig: str, visited: np.ndarray) -> None:
    """Mark the store rows of every kmer of `contig` as visited."""
    from ..constants import CHAR_TO_BASE
    from ..ops import kmer as kops
    from ..ops import sorted as sops
    k = g.k
    codes = CHAR_TO_BASE[np.frombuffer(contig.encode(), np.uint8)]
    if len(codes) < k:
        return
    kmers, valid = kops.rolling_kmers(
        torch.from_numpy(codes[None]).to(g.device), k)
    keys, _ = kops.canonical(kmers, k)
    idx, found = sops.lookup(g.keys, keys[0])
    rows = idx[valid[0] & found].cpu().numpy()
    visited[rows[rows < len(visited)]] = True


# ---------------------------------------------------------------------------
# pview (ref: src/commands/ctx_pview.c)
# ---------------------------------------------------------------------------

def cmd_pview(argv):
    p = argparse.ArgumentParser(prog="mctx-torch pview")
    p.add_argument("ctx")
    p.add_argument("ctp")
    args = p.parse_args(argv)
    import gzip
    with open(args.ctp, "rb") as probe:
        is_gz = probe.read(2) == b"\x1f\x8b"
    opener = gzip.open if is_gz else open
    with opener(args.ctp, "rt") as fh:
        sys.stdout.write(fh.read())
    return 0


# ---------------------------------------------------------------------------
# thread (ref: src/commands/ctx_thread.c)
# ---------------------------------------------------------------------------

def cmd_thread(argv):
    p = argparse.ArgumentParser(prog="mctx-torch thread")
    p.add_argument("-1", "--seq", action="append", default=[],
                   help="read files to thread")
    p.add_argument("-p", "--paths", action="append", default=[],
                   help="existing .ctp files to load first")
    p.add_argument("-o", "--out", required=True, help="output .ctp[.gz]")
    p.add_argument("--colour", type=int, default=0,
                   help="link colour to record")
    p.add_argument("--gap-fill", dest="gap_fill", action="store_true",
                   default=True,
                   help="bridge read errors through the graph while "
                        "threading (default, ref one-way gap filling)")
    p.add_argument("--no-gap-fill", dest="gap_fill", action="store_false")
    p.add_argument("-2", "--seq2", action="append", nargs=2, default=[],
                   metavar=("R1", "R2"),
                   help="paired-end read files (mates joined across the "
                        "insert, ref ctx_thread.c -2)")
    p.add_argument("-i", "--seqi", action="append", default=[],
                   help="interleaved paired-end reads in one file "
                        "(ref ctx_thread.c -i)")
    p.add_argument("-M", "--matepair", default="FR",
                   choices=["FF", "FR", "RF", "RR"],
                   help="mate pair orientation [default: FR]")
    p.add_argument("-O", "--fq-offset", type=int, default=0,
                   help="FASTQ ASCII offset: 33/64 [default: 0 = auto]")
    p.add_argument("-H", "--cut-hp", type=int, default=0,
                   help="break reads at homopolymer runs >= this")
    p.add_argument("-X", "--max-context", type=int, default=None,
                   help="kmers of aligned context to prime gap walkers "
                        "with on either side of a gap [default: 200]")
    p.add_argument("-e", "--end-check", dest="end_check",
                   action="store_true", default=True,
                   help="verify the walker agrees with the read after "
                        "bridging a gap [default: on]")
    p.add_argument("-E", "--no-end-check", dest="end_check",
                   action="store_false")
    p.add_argument("-0", "--zero-paths", action="store_true",
                   help="zero counts on initially loaded links")
    p.add_argument("-u", "--use-new-paths", action="store_true",
                   help="use links as they are being added (batch "
                        "granularity)")
    p.add_argument("-L", "--max-frag-len", "--frag-len", type=int,
                   dest="frag_len", default=1000,
                   help="max fragment length for insert-gap bridging "
                        "(ref ctx_thread.c -L)")
    p.add_argument("-l", "--min-frag-len", type=int, default=0,
                   help="min fragment length for --seq2/--seqi "
                        "(ref ctx_thread.c -l)")
    p.add_argument("-w", "--one-way", dest="one_way",
                   action="store_true", default=True,
                   help="one-way gap filling (conservative, default)")
    p.add_argument("-W", "--two-way", dest="one_way",
                   action="store_false",
                   help="two-way (meet-in-the-middle) gap filling")
    p.add_argument("-g", "--gap-hist", default=None,
                   help="save gap size distribution CSV")
    p.add_argument("-G", "--frag-hist", default=None,
                   help="save PE fragment size distribution CSV")
    p.add_argument("-Q", "--fq-cutoff", type=int, default=0,
                   help="mask bases with quality < Q before threading")
    p.add_argument("-d", "--gap-diff-const", type=float, default=5,
                   help="allowable gap: |exp-seen| <= exp*D + d")
    p.add_argument("-D", "--gap-diff-coeff", type=float, default=0.1,
                   help="gap tolerance coefficient")
    p.add_argument("-x", "--print-contigs", action="store_true",
                   help="debug: print each aligned node-path run")
    p.add_argument("-y", "--print-paths", action="store_true",
                   help="debug: dump the built links as text")
    p.add_argument("-z", "--print-reads", action="store_true",
                   help="debug: print each read as threaded")
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("ctx")
    add_common(p)
    args = p.parse_args(_expand_pe_colon(argv))
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
    status, device = apply_common(args, args.out, args.gap_hist,
                                  args.frag_hist)
    if not args.seq and not args.seq2 and not args.seqi:
        p.error("at least one --seq/--seq2/--seqi required")
    if args.fq_offset not in (0, 33, 64):
        p.error("--fq-offset must be 33 or 64 (0 = auto)")
    timing.SPANS.clear()
    import dataclasses
    from ..align.correct import CorrectAlnStats
    from ..io import ctp as ctpio
    from ..io import seqio
    from ..links import store as lstore
    from ..links import thread as lthread
    h, g = _load_graphs([args.ctx], device)
    ncols = max(h.ncols, args.colour + 1)
    stats = lthread.ThreadStats(ncols)
    aln_stats = CorrectAlnStats()

    with timing.span("read"):
        batches = [(_mask_reads(codes, quals, args.fq_cutoff, args.cut_hp),
                    args.colour)
                   for codes, quals, _ in seqio.read_batches(
                       args.seq, fq_offset=args.fq_offset)]
    if args.print_reads:
        for bcodes, _c in batches:
            for row in bcodes:
                s = _BASE_CHARS[np.minimum(row, 4)].tobytes().decode()
                print(f"read: {s.rstrip('N')}")
    # loaded links guide the gap-fill walkers (ref generate_paths threads
    # against already-loaded paths; -u also exposes this run's links to
    # later batches)
    prev = ctpio.load_link_store(args.paths, g) if args.paths else None
    if args.zero_paths and prev is not None:
        prev = dataclasses.replace(prev, nseen=torch.zeros_like(prev.nseen))
    with timing.span("thread", device):
        if args.gap_fill:
            links = lthread.thread_reads_gapfill(
                g, batches, ncols, links_prev=prev, stats=stats,
                one_way=args.one_way, gap_variance=args.gap_diff_coeff,
                gap_wiggle=args.gap_diff_const,
                max_context=args.max_context, end_check=args.end_check,
                use_new_paths=args.use_new_paths, aln_stats=aln_stats)
        elif batches:
            links = lthread.thread_reads(g, batches, ncols, stats=stats)
        else:
            links = None
    if args.print_contigs:
        for bcodes, _c in batches:
            idx, orient, valid = (
                t.cpu().numpy() for t in
                lthread.reads_to_node_paths(g, bcodes, g.k))
            for b in range(idx.shape[0]):
                segs = []
                run = []
                for j in range(idx.shape[1]):
                    if valid[b, j]:
                        run.append(f"{idx[b, j]}:{int(orient[b, j])}")
                    elif run:
                        segs.append(" ".join(run))
                        run = []
                if run:
                    segs.append(" ".join(run))
                print(f"contig[{b}]: " + " | ".join(segs))
    # pairs: mates joined across the insert through the graph, then
    # threaded as one path (ref generate_paths in PE mode); -d/-D apply to
    # single reads only, as in mctx
    npe = 0
    if args.seq2 or args.seqi:
        with timing.span("read"):
            pair_batches = []
            for r1, r2 in args.seq2:
                for c1, c2, _ in seqio.read_batches_pe(
                        r1, r2, colour=args.colour, matedir=args.matepair,
                        fq_offset=args.fq_offset):
                    pair_batches.append((c1, c2, args.colour))
                    npe += c1.shape[0]
            # mctx's status line counts the pairs of -2 only
            for fi in args.seqi:
                for c1, c2, _q1, _q2, _ in seqio.read_batches_interleaved(
                        fi, colour=args.colour, matedir=args.matepair,
                        fq_offset=args.fq_offset):
                    pair_batches.append((c1, c2, args.colour))
        with timing.span("thread", device):
            pe_links = lthread.thread_reads_pe(
                g, pair_batches, ncols, links_prev=prev,
                frag_len_min=args.min_frag_len, frag_len_max=args.frag_len,
                stats=stats, one_way=args.one_way,
                max_context=args.max_context, end_check=args.end_check,
                aln_stats=aln_stats)
        links = pe_links if links is None else lstore.merge_stores(
            links, pe_links, g.capacity)
    prev_commands = []
    if args.paths:
        if args.zero_paths:
            status("zeroing link counts for loaded links")
        links = lstore.merge_stores(prev, links, g.capacity)
        # contig histograms and provenance from the input link files (ref
        # ctx_thread.c:208 gpath_reader_load_contig_hist)
        for pth in args.paths:
            phdr = ctpio.load_ctp_header(pth)
            prev_commands.extend(phdr.get("commands", []))
            for c in range(ncols):
                for lng, cnt in ctpio.contig_hist_from_header(
                        phdr, c).items():
                    stats.add_contig(c, lng, cnt)
    status(f"threaded {sum(b.shape[0] for b, _ in batches)} reads + "
           f"{npe} pairs -> {links.nlinks} links")
    if aln_stats.num_gap_attempts:
        status("[CorrectAln] " + aln_stats.summary())
    if args.gap_hist:
        aln_stats.dump_gaps(args.gap_hist)
        status(f"[CorrectAln] saved gap size distribution to: "
               f"{args.gap_hist}")
    if args.frag_hist:
        aln_stats.dump_fraglen(args.frag_hist)
        status(f"[CorrectAln] saved fragment size distribution to: "
               f"{args.frag_hist}")
    with timing.span("write"):
        # the command line as recorded omits --device: where the kernels
        # ran does not change the links
        ctpio.save_ctp(args.out, g, links,
                       sample_names=[gi.sample_name for gi in h.ginfo],
                       command="mctx thread " + " ".join(
                           _without_device(argv)),
                       contig_hists=stats.contig_hists,
                       prev_commands=prev_commands)
    if args.print_paths:
        import gzip
        opener = gzip.open if args.out.endswith(".gz") else open
        with opener(args.out, "rt") as fh:
            for line in fh:
                if not line.startswith("#"):
                    sys.stdout.write(line)
    status(f"time split: {timing.summary()}")
    return 0



# ---------------------------------------------------------------------------
# bubbles (ref: src/commands/ctx_bubbles.c)
# ---------------------------------------------------------------------------

def cmd_bubbles(argv):
    p = argparse.ArgumentParser(prog="mctx-torch bubbles")
    p.add_argument("-o", "--out", required=True, help="output .txt.gz")
    p.add_argument("-p", "--paths", action="append", default=[])
    p.add_argument("-A", "--max-allele", type=int, default=300)
    p.add_argument("-F", "--max-flank", type=int, default=1000)
    p.add_argument("-H", "--haploid", default="",
                   help="comma-separated haploid colour list; "
                        "'*' means all colours")
    p.add_argument("-S", "--keep-serial", dest="keep_serial",
                   action="store_true",
                   help="keep serial (chained) bubbles "
                        "(ref ctx_bubbles.c -S; higher FP)")
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
    status, device = apply_common(args, args.out)
    timing.SPANS.clear()
    from ..calls import bubbles as bub
    from ..io import callfile
    from ..io import ctp as ctpio
    h, g = _load_graphs(args.ctx, device)
    links = None
    if args.paths:
        with timing.span("links", device):
            links = ctpio.load_link_store(args.paths, g)
    haploid = (list(range(h.ncols)) if args.haploid.strip() == "*"
               else [int(x) for x in args.haploid.split(",") if x != ""])
    with timing.span("call", device):
        bl = bub.call_bubbles(g, links, max_allele=args.max_allele,
                              max_flank=args.max_flank, haploid_cols=haploid,
                              remove_serial=not args.keep_serial)
    with timing.span("write"):
        callfile.write_bubble_file(
            args.out, bl, g.k, h.ncols, args.max_allele, args.max_flank,
            sample_names=[gi.sample_name for gi in h.ginfo])
    status(f"found {len(bl)} bubbles -> {args.out}")
    status(f"time split: {timing.summary()}")
    return 0


_BASE_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def _mask_reads(codes, quals, fq_cutoff, hp_cutoff):
    """Host base codes with low-quality bases (-Q, where the reads have
    qualities) and long homopolymers (-H) set to N; unchanged when
    neither applies."""
    if (fq_cutoff and quals is not None) or hp_cutoff:
        from ..graph import build as gbuild
        return gbuild.mask_reads(
            torch.from_numpy(codes),
            torch.from_numpy(quals) if quals is not None else None,
            fq_cutoff=fq_cutoff if quals is not None else 0,
            hp_cutoff=hp_cutoff).numpy()
    return codes


def _without_device(argv) -> list:
    """argv less its --device option."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        elif not a.startswith("--device="):
            out.append(a)
    return out


def _expand_pe_colon(argv):
    """Rewrite the reference's '-2 in1:in2' form to the two-argument
    form."""
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-2", "--seq2") and i + 1 < len(argv) \
                and ":" in argv[i + 1]:
            out += [a] + argv[i + 1].split(":", 1)
            i += 2
        else:
            out.append(a)
            i += 1
    return out


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

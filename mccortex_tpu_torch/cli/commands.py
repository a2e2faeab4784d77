"""mctx-torch subcommands (counterpart of mccortex_tpu/cli/commands.py).

Ported so far: build, clean, unitigs.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..utils import timing
from .common import add_common, apply_common, check_kmer

# build inputs and options of `mctx build` that this port does not run yet
_NOT_PORTED_TASKS = ("-2", "--seq2", "-i", "--seqi", "-g", "--graph")


def _not_ported(p, flag: str):
    p.error(f"{flag} is not yet ported to mctx-torch (use mctx)")


def cmd_build(argv):
    p = argparse.ArgumentParser(
        prog="mctx-torch build",
        description="reads -> coloured .ctx graph",
        epilog="colour tasks (order on the command line defines the "
               "colours): -s/--sample <name> starts a colour; "
               "-1/--seq <in> adds a FASTA/FASTQ file (plain or gz) to it")
    p.add_argument("-k", "--kmer", type=int, required=True)
    p.add_argument("-Q", "--fq-cutoff", type=int, default=0)
    p.add_argument("-O", "--fq-offset", type=int, default=0,
                   help="FASTQ quality ASCII offset: 33 or 64 "
                        "[default: 0 = auto-detect per file]")
    p.add_argument("-H", "--cut-hp", type=int, default=0)
    p.add_argument("-p", "--remove-pcr", action="store_true",
                   help="not yet ported")
    p.add_argument("-I", "--intersect", default=None, help="not yet ported")
    p.add_argument("-m", "--memory", default=None, help="not yet ported")
    p.add_argument("--devices", default=None, help="not yet ported")
    p.add_argument("-o", "--out", dest="out_explicit", default=None)
    p.add_argument("out", nargs="?", default=None)
    add_common(p)
    args, tasks = _parse_build_tasks(p, argv)
    for flag, val in (("-p/--remove-pcr", args.remove_pcr),
                      ("-I/--intersect", args.intersect),
                      ("-m/--memory", args.memory),
                      ("--devices", args.devices)):
        if val:
            _not_ported(p, flag)
    out = args.out_explicit or args.out
    if not out:
        p.error("output .ctx path required")
    if not tasks:
        p.error("at least one --sample ... --seq ... required")
    if args.fq_offset not in (0, 33, 64):
        p.error("--fq-offset must be 33 or 64 (0 = auto)")
    k = check_kmer(args.kmer, p)
    status, device = apply_common(args, out)

    from ..graph import build as gbuild
    from ..graph import store as gstore
    from ..io import ctx as ctxio
    from ..io import seqio

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
    t0 = time.perf_counter()
    for colour, (sample, files) in enumerate(tasks):
        total_seq = 0
        nreads = 0
        for path in files:
            for codes, quals, _ in seqio.read_batches_chunked(
                    [path], colour=colour, overlap=k,
                    fq_offset=args.fq_offset):
                codes = _mask(codes, quals)
                total_seq += int((codes < 4).sum())
                nreads += codes.shape[0]
                batches.append((codes, colour))
        ginfo.append(ctxio.GraphInfo(
            sample_name=sample, total_sequence=total_seq,
            mean_read_length=total_seq // max(nreads, 1)))
        status(f"colour {colour} '{sample}': {nreads} reads, "
               f"{total_seq} bases")
    ncols = len(tasks)
    status(f"read {len(batches)} batches in {time.perf_counter() - t0:.3f}s")

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    t0 = time.perf_counter()
    g = gbuild.build(batches, k, ncols=ncols, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    status(f"built {g.n} kmers from {len(batches)} batches in "
           f"{time.perf_counter() - t0:.3f}s on {where}")
    t0 = time.perf_counter()
    keys, covg, edges = gstore.to_host(g)
    hdr = ctxio.CtxHeader(kmer_size=k, ginfo=ginfo)
    ctxio.write_ctx(out, hdr, keys, covg, edges)
    status(f"wrote {len(keys)} kmers x {ncols} colours to {out} in "
           f"{time.perf_counter() - t0:.3f}s")
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
        allk, allc, alle, ginfo = [], [], [], []
        off = 0
        for h, keys, covg, edges in loaded:
            cw = np.zeros((len(keys), ncols), np.uint32)
            ew = np.zeros((len(keys), ncols), np.uint8)
            cw[:, off:off + h.ncols] = covg
            ew[:, off:off + h.ncols] = edges
            ginfo.extend(h.ginfo)
            off += h.ncols
            allk.append(keys)
            allc.append(cw)
            alle.append(ew)
        g = gstore.from_records(
            k, torch.from_numpy(np.concatenate(allk).view(np.int64)).to(device),
            torch.from_numpy(np.concatenate(allc).view(np.int32)).to(device),
            torch.from_numpy(np.concatenate(alle)).to(device))
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
    """Pair each --sample with the --seq files that follow it, in
    command-line order; every other argument goes to the parser."""
    tasks = []       # (sample name, [files])
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-s", "--sample", "-1", "--seq", "--seq1") and \
                i + 1 >= len(argv):
            p.error(f"{a} needs an argument")
        if a in ("-s", "--sample"):
            tasks.append((argv[i + 1], []))
            i += 2
        elif a in ("-1", "--seq", "--seq1"):
            if not tasks:
                p.error(f"{a} {argv[i + 1]}: give --sample first")
            tasks[-1][1].append(argv[i + 1])
            i += 2
        elif a in _NOT_PORTED_TASKS:
            _not_ported(p, a)
        else:
            rest.append(a)
            i += 1
    return p.parse_args(rest), tasks

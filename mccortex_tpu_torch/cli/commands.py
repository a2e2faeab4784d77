"""mctx-torch subcommands (counterpart of mccortex_tpu/cli/commands.py).

Ported so far: build.
"""

from __future__ import annotations

import argparse
import time

import torch

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

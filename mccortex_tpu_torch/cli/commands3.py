"""mctx-torch subcommands of mccortex_tpu/cli/commands3.py: correct,
links, breakpoints, calls2vcf, vcfcov, vcfgeno and hashtest.

correct bridges the gaps of each read (of each mate pair, across the
insert) through the graph with align/correct.py, the reads mapped to
node paths by the batched lookup (on a CUDA store the lookup kernel);
links traces every link along the graph on the device and cleans or
inspects the junction trees on the host (links/link_tree.py).
breakpoints walks the non-reference branches of the graph
(calls/breakpoints.py); calls2vcf and vcfgeno are host code on a call
file or a VCF; vcfcov looks the haplotypes' kmers up in the graph
(calls/genotyping.py, the lookup kernel on the card); hashtest times
one build epoch and a binary-search lookup on the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json

import numpy as np
import torch

from ..align import nw
from ..utils import timing
from .commands import _load_graphs, _mask_reads, _without_device
from .common import add_common, apply_common, check_outfile


# ---------------------------------------------------------------------------
# correct (ref ctx_correct.c)
# ---------------------------------------------------------------------------

def cmd_correct(argv):
    p = argparse.ArgumentParser(prog="mctx-torch correct")
    p.add_argument("-1", "--seq", action="append", default=[],
                   help="<in>[:<out>] — corrected reads to <out>.fa.gz "
                        "(plain <in> writes to -o)")
    p.add_argument("-2", "--seq2", action="append", nargs="+", default=[],
                   metavar="R",
                   help="paired-end inputs: '<in1> <in2>' (writes to -o "
                        "interleaved) or ref form <in1>:<in2>:<out> "
                        "(writes <out>.{1,2}.fa.gz)")
    p.add_argument("-i", "--seqi", action="append", default=[],
                   help="<in>[:<out>] — interleaved pairs in one file")
    p.add_argument("-F", "--format", default="fasta",
                   type=lambda s: s.lower(),
                   choices=["fasta", "fastq"],
                   help="output format [default: FASTA, like ref "
                        "correct's .fa.gz outputs]")
    p.add_argument("-M", "--matepair", default="FR",
                   choices=["FF", "FR", "RF", "RR"])
    p.add_argument("-Q", "--fq-cutoff", type=int, default=0,
                   help="mask bases with quality < Q before correcting")
    p.add_argument("-O", "--fq-offset", type=int, default=0,
                   help="FASTQ ASCII offset: 33/64 [default: 0 = auto]")
    p.add_argument("-H", "--cut-hp", type=int, default=0,
                   help="break reads at homopolymer runs >= this")
    p.add_argument("-Z", "--fq-zero", default=None,
                   help="FASTQ output: replace zero quality scores "
                        "with this character (ref ctx_correct.c -Z)")
    p.add_argument("-P", "--print-orig", action="store_true",
                   help="append ' orig=SEQ' to each read name")
    p.add_argument("-l", "--min-frag-len", type=int, default=0)
    p.add_argument("-L", "--max-frag-len", type=int, default=1000)
    p.add_argument("-X", "--max-context", type=int, default=None,
                   help="kmers of aligned context to prime gap walkers "
                        "with [default: 200]")
    p.add_argument("-e", "--end-check", dest="end_check",
                   action="store_true", default=True,
                   help="verify walker/read agreement after bridging "
                        "[default: on]")
    p.add_argument("-E", "--no-end-check", dest="end_check",
                   action="store_false")
    p.add_argument("-p", "--paths", action="append", default=[])
    p.add_argument("-o", "--out", default=None,
                   help="output for plain --seq/--seq2 inputs")
    p.add_argument("-c", "--colour", type=int, default=0)
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
    p.add_argument("-C", "--contig-hist", default=None,
                   help="save corrected-segment length distribution CSV")
    p.add_argument("-d", "--gap-diff-const", type=float, default=5,
                   help="allowable gap: |exp-seen| <= exp*D + d")
    p.add_argument("-D", "--gap-diff-coeff", type=float, default=0.1,
                   help="gap tolerance coefficient")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for parity")
    p.add_argument("ctx")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.gap_hist, args.frag_hist,
                                  args.contig_hist)
    if not args.seq and not args.seq2 and not args.seqi:
        p.error("at least one --seq/--seq2/--seqi required")
    from ..align import correct as acorrect
    from ..io import ctp as ctpio
    from ..io import seqio
    from ..io.seqio import Read
    from .commands2 import _SeqWriter, _chunks, _codes, _pow2_len
    # the offset goes to each reader as an argument (mctx sets a
    # process-wide default instead)
    if args.fq_offset and args.fq_offset not in (33, 64):
        p.error("--fq-offset must be 33 or 64 (0 = auto)")
    if args.max_context is None:
        args.max_context = acorrect.MAX_CONTEXT
    timing.reset()
    h, g = _load_graphs([args.ctx], device)
    links = ctpio.load_link_store(args.paths, g) if args.paths else None
    aln_stats = acorrect.CorrectAlnStats()
    nreads = nfixed = ngaps = 0
    ext = ".fq.gz" if args.format == "fastq" else ".fa.gz"

    def _emit(wr, name, cr, orig_rd):
        nonlocal nreads, nfixed, ngaps
        if args.print_orig:
            name = f"{name} orig={orig_rd.seq}"
        quals = None
        if args.format == "fastq":
            q = orig_rd.quals
            if q is not None and len(q) == len(cr.display):
                quals = np.asarray(q).copy()
            else:
                quals = np.zeros(len(cr.display), np.uint8)
            if args.fq_zero:
                zc = max(ord(args.fq_zero[0]) - 33, 0)
                quals = np.where(quals == 0, zc, quals)
        wr.write(Read(name, cr.display, quals))
        aln_stats.add_contig(len(cr.display))
        nreads += 1
        ngaps += cr.ngaps
        nfixed += cr.nfixed

    def _correct_chunk(rds, wr):
        # one power-of-two row length a chunk
        L = _pow2_len(max(len(r.seq) for r in rds))
        arr = np.full((len(rds), L), 4, np.uint8)
        quals = None
        if args.fq_cutoff and any(r.quals is not None for r in rds):
            quals = np.zeros((len(rds), L), np.uint8)
        for i, r in enumerate(rds):
            arr[i, :len(r.seq)] = _codes(r.seq)
            if quals is not None and r.quals is not None:
                quals[i, :len(r.quals)] = r.quals
        arr = _mask_reads(arr, quals, args.fq_cutoff, args.cut_hp)
        with timing.span("gapfill", device):
            res = acorrect.correct_batch(
                g, links, arr, colour=args.colour, one_way=args.one_way,
                gap_variance=args.gap_diff_coeff,
                gap_wiggle=args.gap_diff_const,
                max_context=args.max_context, end_check=args.end_check,
                aln_stats=aln_stats)
        for rd, cr in zip(rds, res):
            # strip the padding columns: invalid bases past the read's
            # end, rendered as trailing 'n'
            pad = L - len(rd.seq)
            if pad:
                d = cr.display
                strip = 0
                while strip < pad and strip < len(d) and \
                        d[-1 - strip] == "n":
                    strip += 1
                if strip:
                    cr = dataclasses.replace(
                        cr, display=d[:len(d) - strip],
                        seq=(cr.seq[:len(cr.seq) - strip]
                             if cr.seq.endswith("N" * strip)
                             or cr.seq.endswith("n" * strip)
                             else cr.seq))
            _emit(wr, rd.name, cr, rd)

    def _correct_se(path, wr):
        for rds in _chunks(seqio.parse_reads(path, args.fq_offset), 2048):
            _correct_chunk(rds, wr)

    def _correct_pairs(c1, c2, w1, w2):
        with timing.span("gapfill", device):
            m1, m2 = acorrect.correct_pairs(
                g, links, c1, c2, colour=args.colour,
                frag_len_min=args.min_frag_len,
                frag_len_max=args.max_frag_len,
                one_way=args.one_way, max_context=args.max_context,
                end_check=args.end_check, aln_stats=aln_stats)
        for a, b in zip(m1, m2):
            base = f"pair{nreads}"
            _emit(w1, base + "/1", a, Read(base, a.display))
            _emit(w2, base + "/2", b, Read(base, b.display))

    shared = None
    if args.out:
        check_outfile(args.out, args.force)
        fmt = args.format
        if args.out.endswith((".fa", ".fasta")):
            fmt = "fasta"
        shared = _SeqWriter(args.out, fmt)
    for spec in args.seq:
        if ":" in spec:
            path, obase = spec.rsplit(":", 1)
            check_outfile(obase + ext, args.force)
            wr = _SeqWriter(obase + ext, args.format)
            _correct_se(path, wr)
            wr.close()
        else:
            if shared is None:
                p.error(f"--seq {spec}: give <in>:<out> or -o")
            _correct_se(spec, shared)
    for spec in args.seq2:
        if len(spec) == 1:
            try:
                in1, in2, obase = spec[0].rsplit(":", 2)
            except ValueError:
                p.error(f"--seq2 needs <in1>:<in2>:<out>: {spec[0]}")
            check_outfile(obase + ".1" + ext, args.force)
            check_outfile(obase + ".2" + ext, args.force)
            w1 = _SeqWriter(obase + ".1" + ext, args.format)
            w2 = _SeqWriter(obase + ".2" + ext, args.format)
        elif len(spec) == 2:
            in1, in2 = spec
            if shared is None:
                p.error("--seq2 with two args needs -o")
            w1 = w2 = shared
        else:
            p.error("--seq2 takes '<in1> <in2>' or <in1>:<in2>:<out>")
        for c1, c2, _ in seqio.read_batches_pe(
                in1, in2, matedir=args.matepair, fq_offset=args.fq_offset):
            _correct_pairs(c1, c2, w1, w2)
        if w1 is not shared:
            w1.close()
            w2.close()
    for spec in args.seqi:
        if ":" in spec:
            path, obase = spec.rsplit(":", 1)
            check_outfile(obase + ".1" + ext, args.force)
            check_outfile(obase + ".2" + ext, args.force)
            w1 = _SeqWriter(obase + ".1" + ext, args.format)
            w2 = _SeqWriter(obase + ".2" + ext, args.format)
        else:
            path = spec
            if shared is None:
                p.error(f"--seqi {spec}: give <in>:<out> or -o")
            w1 = w2 = shared
        for c1, c2, _q1, _q2, _ in seqio.read_batches_interleaved(
                path, matedir=args.matepair, fq_offset=args.fq_offset):
            _correct_pairs(c1, c2, w1, w2)
        if w1 is not shared:
            w1.close()
            w2.close()
    if shared is not None:
        shared.close()
    status(f"corrected {nreads} reads: {nfixed}/{ngaps} gaps bridged")
    if aln_stats.num_gap_attempts:
        status("[CorrectAln] " + aln_stats.summary())
    if args.gap_hist:
        aln_stats.dump_gaps(args.gap_hist)
    if args.frag_hist:
        aln_stats.dump_fraglen(args.frag_hist)
    if args.contig_hist:
        with open(args.contig_hist, "w") as fh:
            fh.write("SegmentLength,Count\n")
            for lng in sorted(aln_stats.contig_histgrm):
                fh.write(f"{lng},{aln_stats.contig_histgrm[lng]}\n")
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# links (ref ctx_links.c)
# ---------------------------------------------------------------------------

def cmd_links(argv):
    """Clean, minimise and list links (ref ctx_links.c).

    Junction-tree semantics: --clean truncates each link at its first
    junction edge with coverage < N (not whole-link thresholding);
    --threshold picks N per junction distance and takes the median;
    --covg-hist, --list and --plot inspect the trees.  The whole link
    table is traced in one batched pass against the graph (kmer order =
    store row order)."""
    p = argparse.ArgumentParser(prog="mctx-torch links")
    p.add_argument("-c", "--clean", type=int, default=0,
                   help="remove junction choices with coverage < N")
    p.add_argument("-l", "--list", dest="list_csv", default=None,
                   help="write (SeqLen,Covg) CSV of link junction edges")
    p.add_argument("-P", "--plot", default=None,
                   help="write DOT of one kmer's link tree")
    p.add_argument("-T", "--threshold", default=None,
                   help="auto-pick cleaning threshold, write to file")
    p.add_argument("-H", "--covg-hist", default=None,
                   help="write dist x covg link coverage matrix CSV")
    p.add_argument("-D", "--max-dist", type=int, default=6)
    p.add_argument("-C", "--max-covg", type=int, default=100)
    p.add_argument("-L", "--limit", type=int, default=0,
                   help="only use links from first N kmers (row order)")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("ctx")
    p.add_argument("ctp")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out, args.list_csv, args.plot,
                                  args.threshold, args.covg_hist)
    from ..io import ctp as ctpio
    from ..links import link_tree as ltree
    from ..links import store as lstore
    timing.reset()
    h, g = _load_graphs([args.ctx], device)
    with timing.span("links", device):
        links = ctpio.load_ctp(args.ctp, g)
    if args.clean and not args.out:
        p.error("Need to give --out <out.ctp.gz> with --clean")

    if args.limit:
        # the links of the first N kmers with links (row order; the
        # reference limits by .ctp file order)
        offs, seq, nj, nseen = lstore.to_host(links)
        deg = np.diff(offs)
        kmer_has = (deg[0::2] + deg[1::2]) > 0
        rows = np.nonzero(kmer_has)[0][:args.limit]
        keep_v = np.zeros(len(deg), bool)
        keep_v[2 * rows] = keep_v[2 * rows + 1] = True
        lids = np.nonzero(np.repeat(keep_v, deg))[0]
        verts = np.repeat(np.arange(len(deg)), deg)[lids]
        links = lstore.assemble_csr(verts, seq[lids],
                                    nj[lids].astype(np.int64), nseen[lids],
                                    g.capacity, g.device)
        status(f"links: limited to first {len(rows)} kmers "
               f"({links.nlinks} links)")

    need_view = bool(args.list_csv or args.threshold or args.covg_hist
                     or args.clean)
    view = None
    if need_view:
        with timing.span("trace", device):
            jpos, ok, _, _ = ltree.trace_juncpos(g, links)
        if not ok.all():
            status(f"links: WARNING {int((~ok).sum())}/{len(ok)} links "
                   "not walkable in graph")
        with timing.span("tree"):
            view = ltree.LinkTreeView(g, links, jpos)

    if args.covg_hist or args.threshold:
        hists = view.covg_hist(args.max_dist, args.max_covg)
        if args.covg_hist:
            with open(args.covg_hist, "w") as fh:
                fh.write("dist," + ",".join(
                    str(c) for c in range(args.max_covg)) + "\n")
                for d in range(args.max_dist):
                    fh.write(f"{d}," + ",".join(
                        str(int(x)) for x in hists[d]) + "\n")
        if args.threshold:
            sug = ltree.suggest_cutoff(hists)
            with open(args.threshold, "w") as fh:
                ltree.write_threshold_file(fh, sug)
            status(f"links: suggested_cutoff={sug['suggested_cutoff']}")

    keep = None
    if args.clean > 0:
        before = links.nlinks
        with timing.span("tree"):
            links, lstats = view.clean(args.clean)
            keep = view.keep_lengths(args.clean)
        status(f"link clean: {before} -> {lstats['num_links']} links "
               f"({lstats['num_kmers_with_links']} kmers)")

    if args.list_csv:
        rows = view.list_rows(keep)
        with open(args.list_csv, "w") as fh:
            fh.write("SeqLen,Covg\n")
            for sl, cv in rows:
                fh.write(f"{sl},{cv}\n")

    if args.plot:
        deg = np.diff(links.offsets.cpu().numpy())
        rows = np.nonzero((deg[0::2] + deg[1::2]) > 0)[0]
        if len(rows):
            ki = min(args.limit - 1 if args.limit else 0, len(rows) - 1)
            with open(args.plot, "w") as fh:
                ltree.write_dot(g, links, int(rows[ki]), fh)

    if args.out:
        hdr = ctpio.load_ctp_header(args.ctp)
        with timing.span("write"):
            # the command line as recorded omits --device
            ctpio.save_ctp(args.out, g, links,
                           sample_names=[gi.sample_name for gi in h.ginfo],
                           command="mctx links " + " ".join(
                               _without_device(argv)),
                           prev_commands=hdr.get("commands"))
    status(f"time split: {timing.summary()}")
    return 0


# ---------------------------------------------------------------------------
# breakpoints, calls2vcf, vcfcov, vcfgeno (ref ctx_breakpoints.c,
# ctx_calls2vcf.c, ctx_vcfcov.c, ctx_vcfgeno.c)
# ---------------------------------------------------------------------------

def cmd_breakpoints(argv):
    p = argparse.ArgumentParser(prog="mctx-torch breakpoints")
    p.add_argument("-s", "--seq", required=True,
                   help="trusted reference FASTA (indexed for colinear "
                        "runs; the graph should contain the reference "
                        "as a colour — build/join it in, as the "
                        "pipeline does)")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-p", "--paths", action="append", default=[])
    p.add_argument("-r", "--minref", type=int, default=5)
    p.add_argument("-R", "--maxref", type=int, default=1000)
    p.add_argument("-E", "--no-ref-edges", action="store_true",
                   help="ref ctx_breakpoints -E: don't load edges from "
                        "the reference.  Here the reference is a graph "
                        "colour supplied by the user, so its edges are "
                        "whatever the graph holds; accepted for parity")
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    timing.reset()
    from .. import __version__
    from ..calls import breakpoints as bk
    from ..graph import kmer_occur as KO
    from ..io import ctp as ctpio
    h, g = _load_graphs(args.ctx, device)
    ref = KO.RefGenome.from_fasta(args.seq)
    links = ctpio.load_link_store(args.paths, g) if args.paths else None
    with timing.span("call", device):
        calls = bk.call_breakpoints(g, ref, links, min_ref=args.minref,
                                    max_ref=args.maxref)
    hdr = {
        "file_format": "CtxBreakpoints",
        "format_version": 4,
        "ncols": h.ncols,
        "kmer_size": g.k,
        "generator": f"mccortex_tpu_torch {__version__}",
        "commands": [{"cmd": "mctx breakpoints",
                      "min_ref_flank_kmers": args.minref,
                      "max_search_kmers": args.maxref}],
    }
    with timing.span("write"), gzip.open(args.out, "wt") as fh:
        fh.write(json.dumps(hdr, indent=2))
        fh.write("\n\n# generated with mccortex_tpu\n\n")
        for i, bp in enumerate(calls):
            runs5 = bp.flank5p_runs or [dict(bp.flank5p_run, qoffset=0)]
            runs3 = bp.flank3p_runs or [dict(bp.flank3p_run, qoffset=0)]
            c5 = ",".join(_run_str(ref, r, g.k) for r in runs5)
            c3 = ",".join(_run_str(ref, r, g.k) for r in runs3)
            cols = ",".join(map(str, sorted(set(bp.cols))))
            fh.write(f">brkpnt.call{i}.5pflank chr={c5}\n{bp.flank5p_seq}\n")
            fh.write(f">brkpnt.call{i}.3pflank chr={c3}\n{bp.flank3p_seq}\n")
            fh.write(f">brkpnt.call{i}.path cols={cols}\n"
                     f"{bp.allele_seq}\n\n")
    status(f"found {len(calls)} breakpoints -> {args.out}")
    status(f"time split: {timing.summary()}")
    return 0


def cmd_calls2vcf(argv):
    p = argparse.ArgumentParser(prog="mctx-torch calls2vcf")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--out-fmt", default=None,
                   choices=["vcf", "vcfgz", "bcf", "ubcf"],
                   help="output format (ref ctx_calls2vcf -O; default "
                        "by extension)")
    p.add_argument("-F", "--flanks", "--mapped", default=None,
                   help="SAM or BAM of mapped 5' flanks "
                        "(ref ctx_calls2vcf -F)")
    p.add_argument("-Q", "--min-mapq", type=int, default=30,
                   help="min MAPQ for -F placements [30]")
    p.add_argument("-A", "--max-align", type=int, default=500,
                   help="max alignment attempted [500]")
    p.add_argument("-L", "--max-allele", type=int, default=500,
                   help="max allele length printed [500]")
    p.add_argument("-m", "--match", type=int, default=1,
                   help="alignment match score [1]")
    p.add_argument("-M", "--mismatch", type=int, default=-2,
                   help="alignment mismatch score [-2]")
    p.add_argument("-g", "--gap-open", type=int, default=-4,
                   help="alignment gap-open score [-4]")
    p.add_argument("-G", "--gap-extend", type=int, default=-1,
                   help="alignment gap-extend score [-1]")
    p.add_argument("calls", help="bubble or breakpoint call file")
    p.add_argument("ref", help="reference FASTA")
    add_common(p)
    args = p.parse_args(argv)
    status, _device = apply_common(args, args.out)
    from ..calls import calls2vcf as c2v
    from ..graph import kmer_occur as KO
    from ..io import callfile, vcf as vcfio
    # the scores of this call only (mctx sets them process-wide)
    scoring = nw.Scoring(args.match, args.mismatch, args.gap_open,
                         args.gap_extend)
    ref = KO.RefGenome.from_fasta(args.ref)
    hdr, calls = callfile.read_call_file(args.calls)
    k = hdr.get("kmer_size")
    if not k:
        raise ValueError(f"{args.calls}: header lacks kmer_size")
    fmt = hdr.get("file_format", "")
    if fmt == "CtxBreakpoints":
        records, dropped = _breakpoint_calls_to_vcf(
            calls, ref, k, c2v, max_align=args.max_align,
            max_allele=args.max_allele, scoring=scoring)
    else:
        sam_places = None
        if args.flanks:
            sam_places = c2v.load_flank_sam(args.flanks, ref,
                                            args.min_mapq)
        records, dropped = c2v.bubbles_to_vcf(
            calls, ref, k, sam_places=sam_places,
            max_align=args.max_align, max_allele=args.max_allele,
            scoring=scoring)
    out = vcfio.VcfFile(
        headers=vcfio.std_headers(
            args.ref, contigs=[(n, len(s))
                               for n, s in zip(ref.names, ref.seqs)]),
        sample_names=[], records=records)
    vcfio.write_variants(args.out, out, fmt=args.out_fmt)
    status(f"wrote {len(records)} variants ({dropped} calls dropped)")
    return 0


def _run_str(ref, r, k):
    """One colinear ref-run annotation 'chrom:start-end:strand:qoffset'
    in the reference's korun_gzprint format (kmer_occur.c): 1-based
    INCLUSIVE base coordinates (end covers the last kmer's final base;
    start > end on the minus strand), qoffset 1-based in kmers."""
    if r["strand"] == 0:
        s, e = r["first"] + 1, r["last"] + k
    else:
        s, e = r["first"] + k, r["last"] + 1
    return (f"{ref.names[r['chrom']]}:{s}-{e}:"
            f"{'+' if r['strand'] == 0 else '-'}:"
            f"{int(r.get('qoffset', 0)) + 1}")


def _breakpoint_calls_to_vcf(calls, ref, k, c2v, max_align: int = 500,
                             max_allele: int = 500,
                             scoring: nw.Scoring = nw.DEFAULT):
    """Adapt text breakpoint calls (with chr= annotations) into the
    direct decomposition path (a copy of the JAX package's, the
    alignment scores passed down)."""
    from ..io import vcf as vcfio
    from ..utils.dna import revcomp
    name_idx = {n: i for i, n in enumerate(ref.names)}
    records, dropped = [], 0
    for call in calls:
        try:
            # largest-match run choice per flank (ref decomp_brkpt_call:
            # 5' prefers the run nearest the break among the longest,
            # 3' the earliest re-contact among the longest)
            r5 = _largest_run(_parse_chr_runs(call, "flank5p",
                                              name_idx, k), False)
            r3 = _largest_run(_parse_chr_runs(call, "flank3p",
                                              name_idx, k), True)
            allele = call["branches"][0][1] if call["branches"] else ""
        except (KeyError, ValueError):
            dropped += 1
            continue
        if r5 is None or r3 is None or r5["chrom"] != r3["chrom"] or \
           r5["strand"] != r3["strand"]:
            dropped += 1     # unmapped / diff chrom / diff strands
            continue
        ci = r5["chrom"]
        cseq = ref.seqs[ci]
        fw = r5["strand"] == 0
        f5seq = call.get("flank5p", "")
        f3seq = call.get("flank3p", "")
        # footprints in forward ref coords (runs are kmer starts;
        # minus runs have first > last)
        f5lo, f5hi = (min(r5["first"], r5["last"]),
                      max(r5["first"], r5["last"]) + k)
        f3lo, f3hi = (min(r3["first"], r3["last"]),
                      max(r3["first"], r3["last"]) + k)
        # our 3' flank sequence starts AT the re-contact kmer, so the
        # allele/ref boundary sits k-1 bases into the 3' footprint
        if fw:
            ref_start, ref_end = f5hi, f3lo + (k - 1)
        else:
            ref_start, ref_end = f3hi - (k - 1), f5lo
        # flank bases beyond the matched runs join the allele (ref
        # decomp_brkpt_call flank trims); with our caller's runs these
        # are zero, but foreign files may differ
        trim5 = max(len(f5seq) - (r5["qoffset"] + (f5hi - f5lo)), 0)
        trim3 = min(max(r3["qoffset"], 0), len(f3seq))
        if ref_end < ref_start:
            # overlapping flank mappings: trim flanks into the allele
            diff = ref_start - ref_end
            t5 = min(diff, len(f5seq) - trim5)
            trim5 += t5
            diff -= t5
            t3 = min(diff, len(f3seq) - trim3)
            trim3 += t3
            diff -= t3
            if diff > 0:
                dropped += 1     # flanks overlap too much (ref -4)
                continue
            if fw:
                ref_start, ref_end = ref_start - t5, ref_end + t3
            else:
                ref_start, ref_end = ref_start - t3, ref_end + t5
        branch = ((f5seq[len(f5seq) - trim5:] if trim5 else "")
                  + allele + f3seq[:trim3])
        if not fw:
            branch = revcomp(branch)
        if max(ref_end - ref_start, len(branch)) > max_align:
            dropped += 1     # alignment too long to attempt (ref -A)
            continue
        recs = nw.decompose(cseq[ref_start:ref_end], branch, ref_start,
                            cseq, scoring)
        for (p0, r, a) in recs:
            if r != a and max(len(r), len(a)) <= max_allele:
                records.append(vcfio.VcfRecord(
                    chrom=ref.names[ci], pos=p0, vid=call["name"],
                    ref=r, alts=[a]))
    return c2v._dedup(records), dropped


def _parse_chr_runs(call, which, name_idx, k):
    """Parse the comma-separated colinear-run list
    'chr=name:start-end:strand:qoffset,...' from a flank header (ref
    chrom_pos_list_parse, chrom_pos_list.c).  Coordinates are the
    1-based inclusive BASE range of _run_str; converted back to 0-based
    kmer-start first/last.  The legacy 3-field round-2 form (kmer-start
    coords, no qoffset) is still accepted."""
    hdr = call.get(which + "_hdr", "")
    for tok in hdr.split():
        if not tok.startswith("chr="):
            continue
        runs = []
        for body in tok[4:].split(","):
            parts = body.rsplit(":", 3)
            legacy = len(parts) < 4 or not parts[-1].isdigit() or \
                parts[-2] not in ("+", "-")
            if legacy:
                name, rng, strand = body.rsplit(":", 2)
                qoff = 1
            else:
                name, rng, strand, q = parts
                qoff = int(q)
            if name not in name_idx:
                continue
            s, e = (int(x) for x in rng.split("-"))
            if legacy:
                first, last = s - 1, e - 1
            elif strand == "+":
                first, last = s - 1, e - k
            else:
                first, last = s - k, e - 1
            runs.append({"chrom": name_idx[name], "first": first,
                         "last": last,
                         "strand": 0 if strand == "+" else 1,
                         "qoffset": qoff - 1,
                         "len": abs(last - first) + 1})
        return runs
    return []


def _largest_run(runs, use_first):
    """ref chrom_pos_list_get_largest: the longest run; ties broken by
    the lowest qoffset (use_first, 3' flank) or the highest (5')."""
    best = None
    for r in runs:
        if best is None or r["len"] > best["len"] or (
                r["len"] == best["len"]
                and (use_first == (r["qoffset"] < best["qoffset"]))):
            best = r
    return best


def cmd_vcfcov(argv):
    p = argparse.ArgumentParser(prog="mctx-torch vcfcov")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--out-fmt", default=None,
                   choices=["vcf", "vcfgz", "bcf", "ubcf"])
    p.add_argument("-r", "--ref", required=True)
    p.add_argument("-N", "--max-nvars", type=int, default=8,
                   help="limit haplotypes to <= N variants [8]")
    p.add_argument("-L", "--max-var-len", type=int, default=100,
                   help="only use alleles <= this many bases [100]")
    p.add_argument("-M", "--low-mem", action="store_true",
                   help="ref two-pass mode; this implementation always "
                        "streams windows (accepted for parity)")
    p.add_argument("-H", "--high-mem", action="store_true",
                   help="ref one-pass mode (accepted for parity)")
    p.add_argument("vcf")
    p.add_argument("ctx", nargs="+")
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args, args.out)
    timing.reset()
    from ..calls import genotyping as gt
    from ..graph import kmer_occur as KO
    from ..io import vcf as vcfio
    h, g = _load_graphs(args.ctx, device)
    ref = KO.RefGenome.from_fasta(args.ref)
    vcf = vcfio.read_variants(args.vcf)
    if not vcf.sample_names:
        vcf.sample_names = [gi.sample_name for gi in h.ginfo]
    with timing.span("cover", device):
        gt.vcfcov(vcf, ref, g, max_nvars=args.max_nvars,
                  max_var_len=args.max_var_len)
    with timing.span("write"):
        vcfio.write_variants(args.out, vcf, fmt=args.out_fmt)
    status(f"annotated {len(vcf.records)} records with K{g.k}R/K{g.k}A")
    status(f"time split: {timing.summary()}")
    return 0


def cmd_vcfgeno(argv):
    p = argparse.ArgumentParser(prog="mctx-torch vcfgeno")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--out-fmt", default=None,
                   choices=["vcf", "vcfgz", "bcf", "ubcf"])
    p.add_argument("-k", "--kmer", type=int, required=True)
    p.add_argument("-E", "--err", default="0.01",
                   help="per-sample error rates (comma list or one)")
    p.add_argument("-C", "--kcov", default=None,
                   help="kmer coverage per sample (comma list)")
    p.add_argument("-D", "--cov", default=None,
                   help="read depth per sample (comma list); "
                        "kcov = D*(R-k+1)/R")
    p.add_argument("-P", "--ploidy", action="append", default=[],
                   help="'<P>' or 'sample:chr:ploidy' (comma lists, "
                        "'.' = all; repeatable, applied in order — ref "
                        "ctx_vcfgeno -P) [default: 2]")
    p.add_argument("-l", "--llk", action="store_true",
                   help="print all genotype log10 likelihoods "
                        "(FORMAT/GL; ref ctx_vcfgeno -l)")
    p.add_argument("-r", "--rm-cov", action="store_true",
                   help="remove the tags set by vcfcov")
    p.add_argument("-R", "--read-len", default="100",
                   help="mean read length per sample (comma list)")
    p.add_argument("vcf")
    add_common(p)
    args = p.parse_args(argv)
    status, _device = apply_common(args, args.out)
    from ..calls import vcfgeno as vg
    from ..io import vcf as vcfio
    if (args.kcov is None) == (args.cov is None):
        p.error("give exactly one of --kcov / --cov")
    vcf = vcfio.read_variants(args.vcf)
    S = max(len(vcf.sample_names), 1)

    def parse_list(s, cast=float):
        vals = [cast(x) for x in str(s).split(",")]
        return vals * S if len(vals) == 1 else vals

    k = args.kmer
    readlens = parse_list(args.read_len)
    readlensk = [max(r - k + 1, 1) for r in readlens]
    if args.kcov:
        kcovs = parse_list(args.kcov)
    else:
        covs = parse_list(args.cov)
        kcovs = [d * (r - k + 1) / r for d, r in zip(covs, readlens)]
    errs = parse_list(args.err)
    specs = args.ploidy or ["2"]
    if any(":" in s for s in specs):
        ploidies = vg.ploidy_matcher(specs, vcf.sample_names)
    elif len(specs) == 1 and "," in specs[0]:
        ploidies = parse_list(specs[0], int)
    else:
        ploidies = parse_list(specs[-1], int)
    ndone, nskip = vg.genotype_vcf(vcf, k, kcovs, errs, ploidies,
                                   readlensk, add_gl=args.llk,
                                   rm_cov=args.rm_cov)
    vcfio.write_variants(args.out, vcf, fmt=args.out_fmt)
    status(f"genotyped {ndone} records ({nskip} skipped)")
    return 0


def cmd_hashtest(argv):
    """Hidden micro-benchmark (role of ref ctx_exp_hashtest.c): the kmer
    store's insert (one build epoch, graph/build.count_batch: the
    front-end, sort and segreduce kernels on a card) and lookup
    (ops/sorted.lookup, a binary search) rates on the device."""
    p = argparse.ArgumentParser(prog="mctx-torch hashtest")
    p.add_argument("-n", "--num", type=int, default=1 << 20,
                   help="number of kmers")
    p.add_argument("-k", "--kmer", type=int, default=31)
    add_common(p)
    args = p.parse_args(argv)
    status, device = apply_common(args)
    import time
    from ..graph import build as gbuild
    from ..ops import sorted as sops

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    L = 256
    B = max(args.num // (L - args.kmer + 1), 1)
    bases = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    t0 = time.perf_counter()
    keys, _covg, _edges, nu = gbuild.count_batch(
        torch.from_numpy(bases).to(device), args.kmer, 1, 0)
    sync()
    t_ins = time.perf_counter() - t0
    nk = B * (L - args.kmer + 1)
    q = keys[torch.from_numpy(rng.integers(0, max(nu, 1), args.num)
                              ).to(device)]
    t0 = time.perf_counter()
    sops.lookup(keys, q)
    sync()
    t_lk = time.perf_counter() - t0
    status(f"insert: {nk} kmers ({nu} unique) in {t_ins:.3f}s "
           f"({nk / t_ins / 1e6:.1f}M/s)")
    status(f"lookup: {args.num} queries in {t_lk:.3f}s "
           f"({args.num / t_lk / 1e6:.1f}M/s)")
    return 0

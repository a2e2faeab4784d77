"""mctx-torch subcommands of mccortex_tpu/cli/commands3.py: correct and
links.

correct bridges the gaps of each read (of each mate pair, across the
insert) through the graph with align/correct.py, the reads mapped to
node paths by the batched lookup (on a CUDA store the lookup kernel);
links traces every link along the graph on the device and cleans or
inspects the junction trees on the host (links/link_tree.py).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..utils import timing
from .commands import (_load_graphs, _mask_reads, _not_ported,
                       _without_device)
from .common import add_common, apply_common, check_outfile, devices_arg


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
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("ctx")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
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
    timing.SPANS.clear()
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
    p.add_argument("--devices", default=None,
                   help="devices to run on; more than 1 is not yet ported")
    p.add_argument("ctx")
    p.add_argument("ctp")
    add_common(p, memory=True, nkmers=True)
    args = p.parse_args(argv)
    if devices_arg(args) > 1:
        _not_ported(p, "--devices above 1")
    status, device = apply_common(args, args.out, args.list_csv, args.plot,
                                  args.threshold, args.covg_hist)
    from ..io import ctp as ctpio
    from ..links import link_tree as ltree
    from ..links import store as lstore
    timing.SPANS.clear()
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

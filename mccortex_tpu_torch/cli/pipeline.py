"""mctx-torch pipeline — the full multi-sample workflow in one command;
a copy of mccortex_tpu/cli/pipeline.py whose steps are the port's
commands, each run with the pipeline's --device.

Role of ref scripts/make-pipeline.pl: chain
build -> clean -> (join) -> thread -> links-clean -> bubbles/breakpoints
-> calls2vcf -> vcfcov -> vcfgeno (make-pipeline.pl:186-198).  The
reference emits a Makefile; here the steps run directly (each stage's
output file is the checkpoint — a stage is skipped if its output already
exists, mirroring make's resume semantics; --force reruns everything).

Like the perl script: -k takes a comma list or first[:last[:step]]
range and the pipeline runs once per kmer size (outputs under
<outdir>/k<K>/, union VCF at <outdir>/calls.union.vcf); samples can
come from a samples.txt (2-4 columns: name, SE files, PE pairs
in1:in2, interleaved files); --ref joins the reference in as the last
graph colour (the breakpoint caller walks ref kmers).
"""

from __future__ import annotations

import argparse
import os

from .common import Status


def _parse_kmers(spec: str):
    """'21,33' or '27:39:4' -> [int] (make-pipeline.pl kmer parsing)."""
    if "," in spec:
        return [int(x) for x in spec.split(",") if x]
    if ":" in spec:
        parts = [int(x) for x in spec.split(":")]
        first = parts[0]
        last = parts[1] if len(parts) > 1 else first
        step = parts[2] if len(parts) > 2 else 2
        return list(range(first, last + 1, step))
    return [int(spec)]


def _parse_samples_file(path):
    """samples.txt: '<name> <se,..> [<pe1:pe2,..> [<interleaved,..>]]'
    ('.' or '-' = empty column; make-pipeline.pl samples format)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            name = cols[0]
            se = [f for f in (cols[1].split(",") if len(cols) > 1 else [])
                  if f not in (".", "-", "")]
            pe = []
            if len(cols) > 2 and cols[2] not in (".", "-"):
                for pair in cols[2].split(","):
                    a, b = pair.split(":")
                    pe.append((a, b))
            il = [f for f in (cols[3].split(",") if len(cols) > 3 else [])
                  if f not in (".", "-", "")]
            out.append((name, se, pe, il))
    return out


def cmd_pipeline(argv):
    p = argparse.ArgumentParser(prog="mctx-torch pipeline")
    p.add_argument("-k", "--kmer", required=True,
                   help="kmer size(s): '31', '21,33', or "
                        "first[:last[:step]] (make-pipeline.pl)")
    p.add_argument("--sample", action="append", default=[],
                   metavar="NAME:READS[,READS2]",
                   help="sample name and read file(s)")
    p.add_argument("--samples", default=None,
                   help="samples.txt: '<name> <se,..> [<pe1:pe2,..> "
                        "[<interleaved,..>]]' per line")
    p.add_argument("-r", "--ref", default=None,
                   help="reference FASTA (joined in as the last graph "
                        "colour; enables breakpoints + vcf)")
    p.add_argument("-1", "--single-colour", action="store_true",
                   help="build all samples into ONE colour "
                        "(make-pipeline.pl -1)")
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("--no-clean", action="store_true")
    p.add_argument("--no-links-clean", action="store_true",
                   help="skip the link-threshold cleaning step")
    p.add_argument("--contigs", action="store_true",
                   help="also assemble per-sample contigs "
                        "(make-pipeline.pl `contigs` target)")
    p.add_argument("--clean-threshold", type=int, default=0,
                   help="fixed cleaning threshold (default: auto+fallback 2)")
    p.add_argument("--gap-fill", action="store_true", default=True)
    p.add_argument("--kcov", default=None,
                   help="per-sample kmer coverage for genotyping")
    p.add_argument("-g", "--genome", default=None,
                   help="genome size (accepted; used for contig "
                        "confidence when assembling)")
    p.add_argument("-e", "--err", default="0.01",
                   help="sequencing error rate(s) for genotyping")
    p.add_argument("-P", "--ploidy", action="append", default=[],
                   help="'<P>' or 'sample:chr:ploidy' rules "
                        "(repeatable, ref make-pipeline.pl -P)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where every step runs its kernels: the CUDA "
                        "device (default) or their plain PyTorch versions "
                        "on the CPU")
    args = p.parse_args(argv)
    status = Status()

    from .common import check_kmer
    kmers = [check_kmer(x, p) for x in _parse_kmers(args.kmer)]
    samples = []
    for spec in args.sample:
        name, files = spec.split(":", 1)
        samples.append((name, files.split(","), [], []))
    if args.samples:
        samples.extend(_parse_samples_file(args.samples))
    if not samples:
        p.error("give --sample and/or --samples")
    if args.single_colour and len(samples) > 1:
        name = samples[0][0]
        se = sum((s[1] for s in samples), [])
        pe = sum((s[2] for s in samples), [])
        il = sum((s[3] for s in samples), [])
        samples = [(name, se, pe, il)]

    os.makedirs(args.outdir, exist_ok=True)
    union_vcfs = []
    for k in kmers:
        out = args.outdir if len(kmers) == 1 else \
            f"{args.outdir}/k{k}"
        v = _run_one_k(args, k, out, samples, status)
        if v:
            union_vcfs.append(v)

    if len(union_vcfs) > 1:
        # union across kmer sizes (the perl pipeline unions per-k VCFs)
        from ..io import vcf as vcfio
        merged = f"{args.outdir}/calls.union.vcf"
        allrecs = []
        hdrs = None
        for v in union_vcfs:
            vf = vcfio.read_vcf(v)
            hdrs = hdrs or vf.headers
            allrecs.extend(vf.records)
        seen = {}
        for r in sorted(allrecs, key=lambda r: (r.chrom, r.pos)):
            seen.setdefault((r.chrom, r.pos, r.ref, tuple(r.alts)), r)
        vcfio.write_vcf(merged, vcfio.VcfFile(
            headers=hdrs or [], sample_names=[],
            records=list(seen.values())))
        status(f"pipeline: union across k={kmers} -> {merged}")
    status(f"pipeline complete -> {args.outdir}/")
    return 0


def _run_one_k(args, k, out, samples, status):
    """One kmer size end to end; returns the merged VCF path or None."""
    from .main import main as mctx
    os.makedirs(out, exist_ok=True)

    def step(outfile, cmd):
        if not args.force and os.path.exists(outfile):
            status(f"pipeline: {outfile} exists, skipping")
            return
        # inner commands refuse to overwrite without -f; a partial
        # output from an interrupted run must not wedge the resume
        cmd = [cmd[0], "-f"] + cmd[1:]
        status(f"pipeline: mctx {' '.join(cmd)}")
        rc = mctx(cmd + ["--device", args.device])
        if rc != 0:
            raise RuntimeError(f"pipeline step failed: {cmd}")

    # 1. per-sample build (+ optional clean)
    sample_graphs = []
    for name, se, pe, il in samples:
        raw = f"{out}/{name}.raw.ctx"
        cmd = ["build", "-k", str(k), "--sample", name]
        for f in se:
            cmd += ["--seq", f]
        for a, b in pe:
            cmd += ["--seq2", a, b]
        for f in il:
            cmd += ["--seqi", f]
        cmd.append(raw)
        step(raw, cmd)
        if args.no_clean:
            sample_graphs.append(raw)
        else:
            cln = f"{out}/{name}.clean.ctx"
            if args.clean_threshold:
                step(cln, ["clean", "--unitigs",
                           str(args.clean_threshold), "-o", cln, raw])
            else:
                step(cln, ["clean", "--unitigs", "--fallback", "2",
                           "-o", cln, raw])
            sample_graphs.append(cln)

    # 1b. the reference joins in as the LAST colour (make-pipeline.pl
    # builds ref.ctx; the breakpoint caller needs ref kmers in the
    # graph and vcfcov/bubbles treat it as the haploid ref colour)
    if args.ref:
        refg = f"{out}/ref.ctx"
        step(refg, ["build", "-k", str(k), "--sample", "ref",
                    "--seq", args.ref, refg])
        sample_graphs = sample_graphs + [refg]

    # 2. join into one multi-colour graph
    joined = f"{out}/joint.ctx"
    jcmd = ["join", "-o", joined] + sample_graphs
    step(joined, jcmd)

    # 3. per-sample links against the joint graph
    ctps = []
    for ci, (name, se, pe, il) in enumerate(samples):
        ctp = f"{out}/{name}.raw.ctp.gz"
        cmd = ["thread", "--colour", str(ci)]
        if args.gap_fill:
            cmd.append("--gap-fill")
        for f in se:
            cmd += ["--seq", f]
        for a, b in pe:
            cmd += ["--seq2", a, b]
        for f in il:
            cmd += ["--seqi", f]
        cmd += ["-o", ctp, joined]
        step(ctp, cmd)
        # 3b. link cleaning (make-pipeline links target: pick the
        # threshold from the link coverage model, then truncate)
        if args.no_links_clean:
            ctps.append(ctp)
            continue
        thr_file = f"{out}/{name}.ctp.thresh.txt"
        step(thr_file, ["links", "-T", thr_file, joined, ctp])
        thr = 0
        try:
            for line in open(thr_file):
                if line.startswith("suggested_cutoff="):
                    thr = int(float(line.split("=")[1]))
        except OSError:
            pass
        if thr > 1:
            cln = f"{out}/{name}.ctp.gz"
            step(cln, ["links", "-c", str(thr), "-o", cln, joined, ctp])
            ctps.append(cln)
        else:
            ctps.append(ctp)
    merged_ctp = f"{out}/joint.ctp.gz"
    step(merged_ctp, ["pjoin", "-o", merged_ctp, joined] + ctps)

    # 3c. optional per-sample contig assembly (make-pipeline `contigs`)
    if args.contigs:
        for ci, (name, *_rest) in enumerate(samples):
            cfa = f"{out}/{name}.contigs.fa"
            step(cfa, ["contigs", "-c", str(ci), "-p", merged_ctp,
                       "-o", cfa, joined])

    # 4. bubbles (+ breakpoints when a reference is given)
    bub = f"{out}/bubbles.txt.gz"
    bcmd = ["bubbles", "-o", bub, "-p", merged_ctp]
    if args.ref:
        # ref colour is haploid (last colour)
        bcmd += ["--haploid", str(len(samples))]
    step(bub, bcmd + [joined])
    call_files = [bub]
    if args.ref:
        brk = f"{out}/breakpoints.txt.gz"
        step(brk, ["breakpoints", "--seq", args.ref, "-p", merged_ctp,
                   "-o", brk, joined])
        call_files.append(brk)

    # 5. VCF
    if not args.ref:
        return None
    from ..io import vcf as vcfio
    vcfs = []
    for cf in call_files:
        base = os.path.basename(cf).split(".")[0]
        v = f"{out}/{base}.vcf"
        step(v, ["calls2vcf", "-o", v, cf, args.ref])
        vcfs.append(v)
    merged = f"{out}/calls.vcf"
    if args.force or not os.path.exists(merged):
        allrecs = []
        hdrs = None
        for v in vcfs:
            vf = vcfio.read_vcf(v)
            hdrs = hdrs or vf.headers
            allrecs.extend(vf.records)
        seen = {}
        for r in sorted(allrecs, key=lambda r: (r.chrom, r.pos)):
            seen.setdefault((r.chrom, r.pos, r.ref, tuple(r.alts)), r)
        vcfio.write_vcf(merged, vcfio.VcfFile(
            headers=hdrs or [], sample_names=[],
            records=list(seen.values())))
    cov = f"{out}/calls.cov.vcf"
    step(cov, ["vcfcov", "-o", cov, "-r", args.ref, merged, joined])
    if args.kcov:
        geno = f"{out}/calls.geno.vcf"
        kcov = args.kcov
        if "," in kcov and len(kcov.split(",")) == len(samples):
            kcov += ",1"   # the appended ref colour (covg 1 per kmer)
        gcmd = ["vcfgeno", "-o", geno, "-k", str(k),
                "--kcov", kcov, "--err", args.err]
        for pl in (args.ploidy or ["2"]):
            gcmd += ["--ploidy", pl]
        step(geno, gcmd + [cov])
    return merged


"""vcfgeno: genotype calls from kmer coverage; a copy of
mccortex_tpu/calls/vcfgeno.py (standard library and numpy only).

Role of ref src/commands/ctx_vcfgeno.c:100-245: per sample and biallelic
site, convert exclusive-kmer coverages (K<k>R / K<k>A from vcfcov) into
read-arrival counts and score hom-ref / het / hom-alt with Poisson
likelihoods (+ an error term for the unsupported allele); emit
GT/GL/GQ.

    theta_a = kcov * alenk / readlenk        (expected reads on allele)
    rkcov   = covR * rlenk / readlenk        (observed 'reads' on ref)
    llk_hom(c1,c2,th,logerr) = c1*ln(th) - th - lnfac(c1)
                               + c2*(logerr + ln(th))
    llk_het(c1,c2,t1,t2)     = c1*ln(t1/2) - t1/2 - lnfac(c1)
                               + c2*ln(t2/2) - t2/2 - lnfac(c2)
    lenk(pos,len) = min(pos, k-1) + len      (genotyping.h:51)
    kcov from --kcov or --cov: kcov = D*(R-k+1)/R (usage note 3)
"""

from __future__ import annotations

import math


def _lnfac(x: float) -> float:
    return math.lgamma(int(x + 0.5) + 1)


def llk_hom(c1, c2, theta1, logerr):
    lt = math.log(max(theta1, 1e-12))
    return c1 * lt - theta1 - _lnfac(c1) + c2 * (logerr + lt)


def llk_het(c1, c2, t1, t2):
    return (c1 * math.log(max(t1 / 2, 1e-12)) - t1 / 2 - _lnfac(c1)
            + c2 * math.log(max(t2 / 2, 1e-12)) - t2 / 2 - _lnfac(c2))


def _trim(ref, alt, pos):
    rshift = 0
    while ref and alt and ref[0] == alt[0]:
        ref, alt = ref[1:], alt[1:]
        rshift += 1
    while ref and alt and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    return len(ref), len(alt), rshift


def genotype_record(r, k, kcovs, errs, ploidies, readlensk, tagR, tagA,
                    add_gl=True):
    """Genotype one biallelic record in place across samples."""
    rlen, alen, rshift = _trim(r.ref, r.alts[0], r.pos)
    rlenk = min(r.pos + rshift, k - 1) + rlen
    alenk = min(r.pos + rshift, k - 1) + alen
    if "GT" not in r.fmt:
        r.fmt.insert(0, "GT")
    if add_gl and "GL" not in r.fmt:
        r.fmt.append("GL")
    if "GQ" not in r.fmt:
        r.fmt.append("GQ")
    for s, smp in enumerate(r.samples):
        covR, covA = smp.get(tagR, "."), smp.get(tagA, ".")
        ploidy = ploidies[s]
        if covR in (".", None) or covA in (".", None) or ploidy == 0:
            smp["GT"] = "./." if ploidy == 2 else "."
            smp["GQ"] = "."
            if add_gl:
                smp["GL"] = "."
            continue
        covR, covA = float(covR), float(covA)
        readlenk = readlensk[s]
        kcov = kcovs[s]
        logerr = math.log(errs[s])
        theta1 = kcov * rlenk / readlenk
        theta2 = kcov * alenk / readlenk
        rkcov = covR * rlenk / readlenk
        akcov = covA * alenk / readlenk
        ln10 = math.log(10)
        llk = [llk_hom(rkcov, akcov, theta1, logerr) / ln10,
               (llk_het(rkcov, akcov, theta1, theta2) / ln10
                if ploidy == 2 else -1e308),
               llk_hom(akcov, rkcov, theta2, logerr) / ln10]
        order = sorted(range(3), key=lambda i: llk[i])
        best = order[2]
        g0 = 1 if best == 2 else 0
        g1 = 1 if best > 0 else 0
        smp["GT"] = f"{g0}/{g1}" if ploidy == 2 else str(g0)
        smp["GQ"] = int(llk[order[2]] - llk[order[1]] + 0.5)
        if add_gl:
            vals = ([llk[0], llk[2]] if ploidy == 1
                    else [llk[0], llk[1], llk[2]])
            smp["GL"] = ",".join(f"{v:.2f}" for v in vals)


def genotype_vcf(vcf, k, kcovs, errs, ploidy_spec, readlensk,
                 add_gl: bool = True, rm_cov: bool = False):
    """Genotype all biallelic records.  ploidy_spec: per-sample default
    ploidy list, or a callable (sample, chrom) -> ploidy.

    add_gl: emit FORMAT/GL log10 likelihoods (ref ctx_vcfgeno -l).
    rm_cov: strip the vcfcov K<k>R/K<k>A tags afterwards (ref -r)."""
    tagR, tagA = f"K{k}R", f"K{k}A"
    n_done = n_skipped = 0
    for r in vcf.records:
        if len(r.alts) != 1:
            n_skipped += 1
            continue
        if callable(ploidy_spec):
            pl = [ploidy_spec(s, r.chrom) for s in range(len(r.samples))]
        else:
            pl = ploidy_spec
        genotype_record(r, k, kcovs, errs, pl, readlensk, tagR, tagA,
                        add_gl=add_gl)
        n_done += 1
    if rm_cov:
        for r in vcf.records:
            r.fmt = [f for f in r.fmt if f not in (tagR, tagA)]
            for smp in r.samples:
                smp.pop(tagR, None)
                smp.pop(tagA, None)
    vcf.headers += [
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">']
    if add_gl:
        vcf.headers += [
            '##FORMAT=<ID=GL,Number=G,Type=Float,Description="Genotype '
            'log10 likelihoods">']
    vcf.headers += [
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype '
        'quality">']
    return n_done, n_skipped


def ploidy_matcher(specs, sample_names, default: int = 2):
    """Build (sample_idx, chrom) -> ploidy from ref-style -P args
    (ctx_vcfgeno.c: '<P>' or 'sample:chr:ploidy', comma lists, '.' =
    all, applied in order — later rules override earlier ones)."""
    rules = []   # (set[sample]|None, set[chrom]|None, ploidy)
    for spec in specs:
        if ":" not in spec:
            rules.append((None, None, int(spec)))
            continue
        smp, chrom, pl = spec.split(":", 2)
        smps = None if smp == "." else set(smp.split(","))
        chroms = None if chrom == "." else set(chrom.split(","))
        rules.append((smps, chroms, int(pl)))

    def lookup(sample_idx, chrom):
        name = (sample_names[sample_idx]
                if sample_idx < len(sample_names) else "")
        pl = default
        for smps, chroms, v in rules:
            if (smps is None or name in smps) and \
               (chroms is None or chrom in chroms):
                pl = v
        return pl
    return lookup

"""`mctx-torch pipeline` end to end on the CPU: a port copy of
tests/test_pipeline.py (two diploid samples with errory reads over a
2 kb genome, the full workflow, every truth variant recovered in the
final VCF)."""

import os
import random

import pytest

from mccortex_tpu_torch.cli.main import main as port
from mccortex_tpu_torch.io import vcf as vcfio

from test_pipeline import simulate_reads
from util import random_dna


@pytest.mark.slow
def test_port_pipeline_diploid(tmp_path):
    rng = random.Random(4242)
    k = 21
    G = 2000
    ref = random_dna(G, seed=800)
    # truth variants: 3 SNPs + 1 small deletion, het/hom mix over 2 samples
    truth = []  # (pos0, ref, alt)
    snp_pos = [400, 900, 1500]
    for pp in snp_pos:
        alt = "ACGT"[("ACGT".index(ref[pp]) + 1) % 4]
        truth.append((pp, ref[pp], alt))
    del_pos, del_len = 1200, 6

    def apply_snp(seq, pos, alt):
        return seq[:pos] + alt + seq[pos + 1:]

    # sample 1: het at snp0, hom-alt at snp1; carries the deletion het
    s1a = ref
    s1b = apply_snp(apply_snp(ref, snp_pos[0], truth[0][2]),
                    snp_pos[1], truth[1][2])
    s1b = s1b[:del_pos] + s1b[del_pos + del_len:]
    s1a = apply_snp(s1a, snp_pos[1], truth[1][2])
    # sample 2: hom-alt at snp2
    s2a = apply_snp(ref, snp_pos[2], truth[2][2])
    s2b = s2a

    # ~30x per haplotype so het branches survive cleaning
    r1 = simulate_reads(s1a, s1b, 60 * G // 100, 100, 0.005, rng)
    r2 = simulate_reads(s2a, s2b, 60 * G // 100, 100, 0.005, rng)

    ref_fa = str(tmp_path / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(f">ref\n{ref}\n")
    f1 = str(tmp_path / "s1.fa")
    f2 = str(tmp_path / "s2.fa")
    with open(f1, "w") as fh:
        for i, r in enumerate(r1):
            fh.write(f">a{i}\n{r}\n")
    with open(f2, "w") as fh:
        for i, r in enumerate(r2):
            fh.write(f">b{i}\n{r}\n")

    outdir = str(tmp_path / "pipe")
    rc = port(["pipeline", "-k", str(k),
               "--sample", f"s1:{f1}", "--sample", f"s2:{f2}",
               "--ref", ref_fa, "--kcov", "48,48",
               "-o", outdir, "--device", "cpu"])
    assert rc == 0
    vcf = vcfio.read_vcf(os.path.join(outdir, "calls.cov.vcf"))
    found = {(r.pos, r.ref, r.alts[0]) for r in vcf.records}
    # every truth SNP must be present (ref tests/pipeline: no missed
    # truth variants)
    for (pp, rr, aa) in truth:
        assert (pp, rr, aa) in found, (pp, rr, aa, sorted(found))
    # the deletion must be present as an indel overlapping del_pos
    dels = [r for r in vcf.records
            if len(r.ref) - len(r.alts[0]) == del_len
            and abs(r.pos - del_pos) <= k]
    assert dels
    # genotyped VCF exists and has GT fields
    geno = vcfio.read_vcf(os.path.join(outdir, "calls.geno.vcf"))
    assert geno.records and "GT" in geno.records[0].fmt

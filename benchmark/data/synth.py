"""Synthetic samples made from a seed: numpy in, numpy out.

`genome_and_reads`, `reads_of`, `repeat_mask`, `plant_variants` and
`write_fastq` are frozen copies of the recipes of the repository's
`chip_smoke.py` (itself the recipe of `scripts/scale_test.py`): a random
genome with planted repeat families, reads drawn uniformly from it with
substitutions.  `diploid_sample` is new: two haplotypes of one reference
that carry planted SNPs and indels, homozygous or heterozygous, and
reads drawn from both.  `make_sample` reads a configuration's recipe.

Codes are 0..3 for A, C, G, T.
"""

from __future__ import annotations

import numpy as np

VAR_GAP = 300             # every two planted variants at least this apart
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def dna(codes: np.ndarray) -> str:
    return _ACGT[codes].tobytes().decode()


def codes_of(seq: str) -> np.ndarray:
    return np.searchsorted(_ACGT, np.frombuffer(seq.encode(), np.uint8)
                           ).astype(np.uint8)


def genome_and_reads(gsize: int, cov: float, seed: int, rlen: int = 150,
                     err: float = 0.003):
    """Random genome with planted repeat families, and reads sampled from
    it with substitutions (the recipe of scripts/scale_test.py)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, gsize, dtype=np.uint8)
    n_fam = max(4, gsize // 300_000)
    for _ in range(n_fam):
        ulen = int(rng.integers(500, 1500))
        unit = rng.integers(0, 4, ulen, dtype=np.uint8)
        for _ in range(24):
            p = int(rng.integers(0, gsize - ulen))
            genome[p:p + ulen] = unit
    reads, starts = reads_of(genome, cov, rng, rlen, err)
    return genome, reads, starts


def reads_of(genome: np.ndarray, cov: float, rng, rlen: int = 150,
             err: float = 0.003):
    """(reads, starts): reads of `cov` x drawn uniformly from the genome,
    with substitutions at rate `err`."""
    gsize = len(genome)
    nreads = int(gsize * cov / rlen)
    starts = rng.integers(0, gsize - rlen, nreads)
    reads = np.lib.stride_tricks.sliding_window_view(
        genome, rlen)[starts].copy()
    nerr = int(err * reads.size)
    ei = rng.integers(0, nreads, nerr)
    ej = rng.integers(0, rlen, nerr)
    reads[ei, ej] = rng.integers(0, 4, nerr, dtype=np.uint8)
    return reads, starts


def repeat_mask(gsize: int, seed: int) -> np.ndarray:
    """True over the copies of the repeat families genome_and_reads plants
    (the same draws of its generator, in the same order)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, gsize, dtype=np.uint8)
    mask = np.zeros(gsize, bool)
    for _ in range(max(4, gsize // 300_000)):
        ulen = int(rng.integers(500, 1500))
        rng.integers(0, 4, ulen, dtype=np.uint8)
        for _ in range(24):
            p = int(rng.integers(0, gsize - ulen))
            mask[p:p + ulen] = True
    return mask


def plant_variants(genome: np.ndarray, seed: int, nsnp: int, nindel: int):
    """(sample genome, [(pos, REF, ALT)] SNPs, the same of indels): SNPs
    and indels of 1-10 bp planted with numpy at multiples of VAR_GAP;
    indels as VCF writes them (pos = the anchor base before them)."""
    rng = np.random.default_rng(seed)
    nvar = nsnp + nindel
    pos = np.sort(rng.choice(np.arange(2, len(genome) // VAR_GAP - 2), nvar,
                             replace=False)) * VAR_GAP
    is_snp = rng.permutation(nvar) < nsnp
    lens = rng.integers(1, 11, nvar)
    is_ins = rng.random(nvar) < 0.5
    ins = rng.integers(0, 4, (nvar, 10), dtype=np.uint8)
    shift = rng.integers(1, 4, nvar).astype(np.uint8)
    parts, last, snps, indels = [], 0, [], []
    for i, p in enumerate(pos.tolist()):
        if is_snp[i]:
            alt = (genome[p] + shift[i]) % 4
            parts += [genome[last:p], np.array([alt], np.uint8)]
            snps.append((p, dna(genome[p:p + 1]), dna(np.array([alt]))))
            last = p + 1
        elif is_ins[i]:
            parts += [genome[last:p + 1], ins[i, :lens[i]]]
            indels.append((p, dna(genome[p:p + 1]),
                           dna(genome[p:p + 1]) + dna(ins[i, :lens[i]])))
            last = p + 1
        else:
            parts.append(genome[last:p + 1])
            indels.append((p, dna(genome[p:p + 1 + lens[i]]),
                           dna(genome[p:p + 1])))
            last = p + 1 + int(lens[i])
    parts.append(genome[last:])
    return np.concatenate(parts), snps, indels


def write_fastq(path: str, reads: np.ndarray, quals: np.ndarray | None = None):
    seqs = np.frombuffer(b"ACGTN", np.uint8)[reads]
    if quals is None:
        quals = np.full(reads.shape, 40, np.uint8)
    qchars = (quals + 33).astype(np.uint8)
    with open(path, "wb") as fh:
        for i in range(reads.shape[0]):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
                                              qchars[i].tobytes()))


def diploid_sample(gsize: int, seed: int, nsnp: int, nindel: int,
                   het_share: float, cov: float, rlen: int, err: float):
    """(reference, haplotype A, haplotype B, reads): a reference made as
    genome_and_reads makes its genome, SNPs and indels of 1-10 bp planted
    at least VAR_GAP apart, each on both haplotypes (homozygous) or on A
    alone (heterozygous, a share `het_share` of them), and reads of
    `cov` x in all, half from each haplotype, in a shuffled order."""
    ref, _, _ = genome_and_reads(gsize, 0, seed, rlen, err)
    rng = np.random.default_rng([seed, 1])
    hap_a, snps, indels = plant_variants(ref, int(rng.integers(1 << 62)),
                                         nsnp, nindel)
    nvar = len(snps) + len(indels)
    het = rng.permutation(nvar) < round(het_share * nvar)
    # haplotype B: the homozygous variants only, applied to the reference
    # in position order (variants lie VAR_GAP apart, so none overlap)
    variants = sorted(snps + indels)
    parts, last = [], 0
    for (p, ref_s, alt_s), is_het in zip(variants, het):
        if is_het:
            continue
        parts += [ref[last:p], codes_of(alt_s)]
        last = p + len(ref_s)
    parts.append(ref[last:])
    hap_b = np.concatenate(parts)
    ra, _ = reads_of(hap_a, cov / 2, rng, rlen, err)
    rb, _ = reads_of(hap_b, cov / 2, rng, rlen, err)
    reads = np.concatenate([ra, rb])
    reads = reads[rng.permutation(len(reads))]
    return ref, hap_a, hap_b, reads


def make_sample(recipe: dict, seed: int) -> np.ndarray:
    """The reads (n, L) uint8 of a configuration's `sample` recipe."""
    kind = recipe["kind"]
    if kind == "haploid_repeats":
        _, reads, _ = genome_and_reads(recipe["genome_bp"],
                                       recipe["coverage"], seed,
                                       recipe["read_bp"], recipe["error"])
        return reads
    if kind == "diploid_variants":
        return diploid_sample(recipe["genome_bp"], seed, recipe["snps"],
                              recipe["indels"], recipe["het_share"],
                              recipe["coverage"], recipe["read_bp"],
                              recipe["error"])[3]
    raise ValueError(f"unknown sample recipe {kind!r}")

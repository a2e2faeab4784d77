"""vcfcov: annotate VCF records with exclusive-kmer coverage per sample;
counterpart of mccortex_tpu/calls/genotyping.py (the host code copied,
the coverage lookups through ops/hashidx.lookup on the store's device:
the lookup kernel on the card).

Role of ref src/tools/genotyping.c + vcf_coverage.c: for each VCF ALT,
build ref and alt haplotype kmer sets over a window around the variant;
only kmers EXCLUSIVE to one haplotype count; the per-sample tag value is
the mean graph coverage over those exclusive kmers (vmeancovg,
vcf_coverage.c:505: total/nk rounded; missing if no exclusive kmers).

Nearby variants (within k) are combined into joint haplotypes up to
max_nvars variants per window (ref genotyping.h:16-23), so a neighbour's
allele does not break the exclusive-kmer sets.
"""

from __future__ import annotations


import sys

import numpy as np
import torch

from ..graph import store as gstore
from ..ops import hashidx
from ..utils import npkmer as npk
from .calls2vcf import _key_void


def _kmer_keys(seq: str, k: int) -> np.ndarray:
    """Canonical keys of all valid kmers: sortable void rows (vectorised
    numpy, utils/npkmer.py — replaces the per-kmer python set loop)."""
    keys, _, _ = npk.seq_canonical_keys(seq, k)
    return _key_void(keys)


def _void_to_keys(v: np.ndarray, W: int) -> np.ndarray:
    return v.view(">u8").reshape(-1, W).astype(np.uint64)


def _lookup_covg(g: gstore.DBGraph, key_void: np.ndarray) -> np.ndarray:
    """(nk, C) coverage for canonical-key void rows (0 when absent)."""
    if len(key_void) == 0:
        return np.zeros((0, g.ncols), np.uint32)
    keys = torch.from_numpy(_void_to_keys(key_void, g.keys.shape[1]
                                          ).view(np.int64)).to(g.device)
    idx, found = hashidx.lookup(g.keys, keys)
    cov = g.covg[idx.long()].cpu().numpy().view(np.uint32)
    cov[~found.cpu().numpy()] = 0
    return cov


def vcfcov(vcf, ref, g: gstore.DBGraph, max_nvars: int = 8,
           max_var_len: int = 100):
    """Annotate vcf records in place.  Adds FORMAT fields K<k>R / K<k>A
    per sample.  ref: kmer_occur.RefGenome.

    max_var_len: records whose REF or longest ALT exceeds this many
    bases are passed through unannotated (ref vcf_coverage.c:282
    nalts_too_long, -L/--max-var-len, default 100)."""
    k = g.k
    tagR, tagA = f"K{k}R", f"K{k}A"
    chrom_idx = {n: i for i, n in enumerate(ref.names)}
    C = g.ncols
    # group records into windows of nearby variants on the same chrom
    recs = sorted(vcf.records, key=lambda r: (r.chrom, r.pos))
    recs = [r for r in recs
            if max(len(r.ref), max(map(len, r.alts), default=0))
            <= max_var_len]
    groups = []
    for r in recs:
        if groups and groups[-1] and r.chrom == groups[-1][-1].chrom and \
                r.pos - _end(groups[-1][-1]) < k and \
                len(groups[-1]) < max_nvars:
            groups[-1].append(r)
        else:
            groups.append([r])
    n_unknown = 0
    for grp in groups:
        ci = chrom_idx.get(grp[0].chrom)
        if ci is None:
            # unknown contig: mark samples missing
            for r in grp:
                while len(r.samples) < C:
                    r.samples.append({})
                for c in range(C):
                    r.samples[c][tagR] = "."
                    r.samples[c][tagA] = "."
            n_unknown += len(grp)
            continue
        cseq = ref.seqs[ci]
        for r in grp:
            others = [o for o in grp if o is not r]
            _annotate(r, others, cseq, g, k, tagR, tagA, C)
    if n_unknown:
        print(f"[vcfcov] warning: {n_unknown} records on contigs absent "
              "from the reference FASTA (values set to '.')",
              file=sys.stderr)
    # ensure FORMAT listed
    for r in vcf.records:
        for t in (tagR, tagA):
            if t not in r.fmt:
                r.fmt.append(t)
    if not vcf.sample_names:
        vcf.sample_names = [f"sample{c}" for c in range(C)]
    vcf.headers += [
        f'##FORMAT=<ID={tagR},Number=A,Type=Integer,'
        f'Description="Coverage on ref exclusive kmers (k={k})">',
        f'##FORMAT=<ID={tagA},Number=A,Type=Integer,'
        f'Description="Coverage on alt exclusive kmers (k={k})">']


def _end(r):
    return r.pos + len(r.ref)


def _apply(seq, variants, shift):
    """Apply (pos, ref, alt) substitutions (sorted, non-overlapping)."""
    out = []
    cur = 0
    for pos, rf, al in sorted(variants):
        p = pos - shift
        if p < cur:
            return None  # overlapping; skip combination
        out.append(seq[cur:p])
        out.append(al)
        cur = p + len(rf)
    out.append(seq[cur:])
    return "".join(out)


def _annotate(r, others, cseq, g, k, tagR, tagA, C):
    win_s = max(0, r.pos - (k - 1))
    win_e = min(len(cseq), r.pos + len(r.ref) + k - 1)
    base = cseq[win_s:win_e]
    alt = r.alts[0]
    # neighbour variants can be present or absent: build the union of
    # haplotype kmers for ref-allele and alt-allele across neighbour
    # combinations (ref genotyping.c combinations <= max-nvars)
    neigh = [(o.pos, o.ref, o.alts[0]) for o in others
             if o.pos + len(o.ref) <= win_e and o.pos >= win_s]
    ref_lists, alt_lists = [], []
    ncomb = min(len(neigh), 4)  # cap combinations 2^4
    for mask in range(1 << ncomb):
        chosen = [neigh[i] for i in range(ncomb) if mask >> i & 1]
        h_ref = _apply(base, chosen + [(r.pos, r.ref, r.ref)], win_s)
        h_alt = _apply(base, chosen + [(r.pos, r.ref, alt)], win_s)
        if h_ref is not None:
            ref_lists.append(_kmer_keys(h_ref, k))
        if h_alt is not None:
            alt_lists.append(_kmer_keys(h_alt, k))
    empty = np.zeros(0, np.dtype((np.void, 8 * g.keys.shape[1])))
    ref_u = np.unique(np.concatenate(ref_lists)) if ref_lists else empty
    alt_u = np.unique(np.concatenate(alt_lists)) if alt_lists else empty
    excl_r = np.setdiff1d(ref_u, alt_u, assume_unique=True)
    excl_a = np.setdiff1d(alt_u, ref_u, assume_unique=True)
    cov_r = _lookup_covg(g, excl_r)
    cov_a = _lookup_covg(g, excl_a)
    while len(r.samples) < C:
        r.samples.append({})
    for c in range(C):
        if len(excl_r):
            r.samples[c][tagR] = int(cov_r[:, c].sum() / len(excl_r) + 0.5)
        else:
            r.samples[c][tagR] = "."
        if len(excl_a):
            r.samples[c][tagA] = int(cov_a[:, c].sum() / len(excl_a) + 0.5)
        else:
            r.samples[c][tagA] = "."

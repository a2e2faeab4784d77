"""Decompose bubble/breakpoint call files into VCF; a copy of
mccortex_tpu/calls/calls2vcf.py (host numpy) on the port's kmer_occur,
npkmer, dna and seqio, with the alignment scores passed down
(align/nw.Scoring) instead of set process-wide.

Role of ref src/commands/ctx_calls2vcf.c + basic/decomp_bubble.c,
decomp_breakpoint.c, aligned_call.c: place each call on the reference,
align ALT allele vs REF slice with Needleman-Wunsch, decompose into
left-aligned VCF records.

Flank placement: primary placement is by exact unique kmer match
against the reference; when that fails (repetitive flank end), mapped
flanks from a SAM file are consulted (ref ctx_calls2vcf.c -F --flanks,
with -Q/--min-mapq filtering), recovering calls the kmer index alone
would drop.
"""

from __future__ import annotations

import numpy as np

from ..align import nw
from ..graph import kmer_occur as KO
from ..io import vcf as vcfio
from ..utils.dna import revcomp


class RefKmerIndex:
    """Unique-kmer placement index over a reference: canonical key ->
    (chrom, pos, strand), None for repeated keys.

    Vectorised build (utils/npkmer.py) + sorted-array binary search —
    replaces the per-kmer python dict loop that dominated wall-clock at
    genome scale (VERDICT r1 item 6)."""

    def __init__(self, ref: KO.RefGenome, k: int):
        from ..utils import npkmer as npk
        self.k = k
        keys, cis, poss, strands = [], [], [], []
        for ci, seq in enumerate(ref.seqs):
            kk, orient, pos = npk.seq_canonical_keys(seq, k)
            keys.append(kk)
            cis.append(np.full(len(pos), ci, np.int32))
            poss.append(pos.astype(np.int64))
            strands.append(orient)
        if not keys or sum(len(x) for x in keys) == 0:
            self._rep = np.zeros((0, 1), np.uint64)
            self._void = self._rep.view(np.dtype((np.void, 8))).ravel()
            self._payload = np.zeros((0, 3), np.int64)
            self._uniq = np.zeros(0, bool)
            return
        allk = np.concatenate(keys)
        payload = np.stack([np.concatenate(cis).astype(np.int64),
                            np.concatenate(poss),
                            np.concatenate(strands).astype(np.int64)],
                           axis=1)
        v = _key_void(allk)
        # the keys' words in lexicographic order, the void rows' order (of
        # equal keys, which are never placed, the reference keeps an
        # arbitrary one; np.argsort of the void rows takes seconds for a
        # bacterial genome)
        order = np.lexsort(allk.T[::-1])
        sv, payload = v[order], payload[order]
        new = np.ones(len(sv), bool)
        new[1:] = sv[1:] != sv[:-1]
        run_id = np.cumsum(new) - 1
        counts = np.bincount(run_id)
        starts = np.nonzero(new)[0]
        self._void = sv[starts]
        self._payload = payload[starts]
        self._uniq = counts == 1

    def get(self, km: str):
        from ..utils import npkmer as npk
        if len(km) != self.k or len(self._void) == 0:
            return None
        keys, _, pos = npk.seq_canonical_keys(km, self.k)
        if len(keys) == 0:      # contains N
            return None
        qv = _key_void(keys)[0]
        i = np.searchsorted(self._void, qv)
        if i >= len(self._void) or self._void[i] != qv or \
                not self._uniq[i]:
            return None
        ci, p, strand = self._payload[i]
        return int(ci), int(p), int(strand)


def _key_void(keys: np.ndarray) -> np.ndarray:
    """(N, W) u64 -> sortable void rows (big-endian bytes: memcmp order
    == multiword lexicographic order)."""
    W = keys.shape[1]
    be = np.ascontiguousarray(keys.astype(">u8"))
    return be.view(np.dtype((np.void, 8 * W))).ravel()


def _ref_kmer_index(ref: KO.RefGenome, k: int):
    return RefKmerIndex(ref, k)


def load_flank_sam(path: str, ref: KO.RefGenome, min_mapq: int = 30):
    """Parse a SAM/BAM of mapped 5' flanks (ref ctx_calls2vcf.c -F,
    produced by mapping the dumped flank FASTA with e.g. bwa):
    call name -> (chrom index, ref start0, ref end0, strand, mapq).
    Entries below min_mapq or unmapped are omitted."""
    import re
    from ..io.seqio import _openseq, _is_bam
    name_to_ci = {n: i for i, n in enumerate(ref.names)}
    places = {}

    def handle(fields):
        name, flag, rname, pos, mapq, cigar = (
            fields[0], int(fields[1]), fields[2], int(fields[3]),
            int(fields[4]), fields[5])
        if flag & (0x4 | 0x100 | 0x800) or mapq < min_mapq:
            return
        ci = name_to_ci.get(rname)
        if ci is None:
            return
        ref_len = sum(int(n) for n, op in
                      re.findall(r"(\d+)([MIDNSHP=X])", cigar)
                      if op in "MDN=X")
        places[name] = (ci, pos - 1, pos - 1 + ref_len,
                        (flag >> 4) & 1, mapq)

    if _is_bam(path):
        from ..io.seqio import parse_bam_alignments
        for name, flag, rname, pos0, mapq, ref_len in \
                parse_bam_alignments(path):
            if flag & (0x4 | 0x100 | 0x800) or mapq < min_mapq:
                continue
            ci = name_to_ci.get(rname)
            if ci is None:
                continue
            places[name] = (ci, pos0, pos0 + ref_len,
                            (flag >> 4) & 1, mapq)
        return places
    with _openseq(path) as fh:
        for line in fh:
            if line.startswith("@") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) >= 6:
                handle(f)
    return places


def _sam_place5(f5, sam_entry, ref, k):
    """Synthesise a (ci, pos, strand) placement for the 5' flank's last
    kmer from a forward-strand SAM alignment of the whole flank."""
    ci, s0, e0, strand, _q = sam_entry
    if strand != 0 or e0 - s0 < k:
        return None
    pos = e0 - k
    km = f5[-k:]
    # verify the reference agrees (soft-clips etc. can shift the end)
    if ref.seqs[ci][pos:pos + k] != km:
        return None
    return (ci, pos, 0 if km <= revcomp(km) else 1)


def bubbles_to_vcf(calls, ref: KO.RefGenome, k: int, sam_places=None,
                   max_align: int = 500, max_allele: int = 500,
                   scoring: nw.Scoring = nw.DEFAULT):
    """Returns (records, n_dropped).  calls from callfile.read_call_file.

    max_align: skip alignments longer than this (ref ctx_calls2vcf -A,
    DEFAULT_MAX_ALIGN); max_allele: drop records whose REF or ALT
    allele exceeds this many bases (-L, DEFAULT_MAX_ALLELE).

    If the 5' flank places on the reverse strand, the whole call is
    flipped to the forward strand first (swap + revcomp flanks and
    branches), then decomposed with forward-strand logic.

    sam_places (from load_flank_sam) supplies mapped-flank placements
    (ref ctx_calls2vcf.c -F): used when unique-kmer placement fails
    (repetitive flank ends); a reverse-strand mapping flips the call
    exactly like a reverse kmer placement."""
    kidx = _ref_kmer_index(ref, k)
    sam_places = sam_places or {}
    records = []
    dropped = 0
    for call in calls:
        f5, f3 = call["flank5p"], call["flank3p"]
        branches = [b for _, b in call["branches"]]
        if len(f5) < k:
            dropped += 1
            continue
        sam = sam_places.get(call.get("name"))
        place = kidx.get(_canon(f5[-k:]))
        flip = place is not None and _strand_of(f5[-k:], place)
        if place is None and sam is not None:
            if sam[3] == 0:
                place = _sam_place5(f5, sam, ref, k)
            else:
                flip = True
        if flip:
            # flip the call to the forward strand
            f5, f3 = revcomp(f3), revcomp(f5)
            branches = [revcomp(b) for b in branches]
            place = kidx.get(_canon(f5[-k:])) if len(f5) >= k else None
        if place is None or len(f5) < k:
            dropped += 1
            continue
        ci, pos, _ = place
        if _strand_of(f5[-k:], place):
            dropped += 1  # still reverse after flip (palindromic region)
            continue
        cseq = ref.seqs[ci]
        ref_start = pos + k  # ref position after the 5' flank
        # place the 3' flank's first kmer
        if len(f3) < k:
            dropped += 1
            continue
        place3 = kidx.get(_canon(f3[:k]))
        if place3 is None or place3[0] != ci or \
                _strand_of(f3[:k], place3):
            dropped += 1
            continue
        ref_end = place3[1]
        if ref_end < ref_start:
            dropped += 1
            continue
        ref_slice = cseq[ref_start:ref_end]
        hit = False
        for bi, branch in enumerate(branches):
            if max(len(ref_slice), len(branch)) > max_align:
                continue   # alignment too long to attempt (ref -A)
            recs = nw.decompose(ref_slice, branch, ref_start, cseq,
                                scoring)
            for (p, r, a) in recs:
                if r != a and max(len(r), len(a)) <= max_allele:
                    records.append(vcfio.VcfRecord(
                        chrom=ref.names[ci], pos=p, vid=call["name"],
                        ref=r, alts=[a]))
                    hit = True
    return _dedup(records), dropped


def _strand_of(km: str, place) -> int:
    """Strand of this kmer occurrence: place stores the canonical key's
    strand; flip if km is not its own canonical form."""
    rc = revcomp(km)
    key_is_fwd = km <= rc
    return place[2] ^ (0 if key_is_fwd else 1)


def breakpoints_to_vcf(bps, ref: KO.RefGenome, k: int,
                       scoring: nw.Scoring = nw.DEFAULT):
    """Decompose Breakpoint dataclasses (calls/breakpoints.py) directly
    using their reference runs (ref decomp_breakpoint.c)."""
    records = []
    dropped = 0
    for bp in bps:
        r5, r3 = bp.flank5p_run, bp.flank3p_run
        if r5["chrom"] != r3["chrom"] or r5["strand"] != 0 or \
           r3["strand"] != 0:
            dropped += 1  # cross-chrom / inverted events: BND records TBD
            continue
        ci = r5["chrom"]
        cseq = ref.seqs[ci]
        ref_start = r5["last"] + k      # after the 5' flank's last base
        ref_end = r3["first"] + k - 1   # before the 3' flank's 1st base
        if ref_end < ref_start:
            dropped += 1
            continue
        ref_slice = cseq[ref_start:ref_end]
        recs = nw.decompose(ref_slice, bp.allele_seq, ref_start, cseq,
                            scoring)
        for (p, r, a) in recs:
            if r != a:
                records.append(vcfio.VcfRecord(
                    chrom=ref.names[ci], pos=p, vid="brkpnt",
                    ref=r, alts=[a],
                    info={"BPCOLS": ",".join(map(str, bp.cols))}))
    return _dedup(records), dropped


def _canon(s):
    rc = revcomp(s)
    return s if s <= rc else rc


def _dedup(records):
    seen = {}
    for r in records:
        key = (r.chrom, r.pos, r.ref, tuple(r.alts))
        if key not in seen:
            seen[key] = r
    return sorted(seen.values(), key=lambda r: (r.chrom, r.pos))

"""Needleman-Wunsch global alignment + VCF decomposition; a copy of
mccortex_tpu/align/nw.py (numpy only) in which the scores are an
argument of align/decompose, not module state.  The reference's
set_scoring (ctx_calls2vcf -m/-M/-g/-G) rewrites module globals, so one
call's scores stay behind for every later call in the process.

Role of ref libs/seq-align (needleman_wunsch.h) as used by
ctx_calls2vcf.c:41-45 (match 1, mismatch -2, gap open -4, gap extend -1)
and src/basic/aligned_call.c acall_decompose: align an ALT allele
against its REF slice and split the alignment into left-aligned VCF
records.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Alignment scores (ref ctx_calls2vcf -m/-M/-g/-G)."""
    match: int = 1
    mismatch: int = -2
    gap_open: int = -4
    gap_extend: int = -1


DEFAULT = Scoring()


def align(a: str, b: str, scoring: Scoring = DEFAULT):
    """Global affine-gap alignment; returns (a_aln, b_aln) with '-' gaps."""
    MATCH, MISMATCH = scoring.match, scoring.mismatch
    GAP_OPEN, GAP_EXTEND = scoring.gap_open, scoring.gap_extend
    n, m = len(a), len(b)
    if n == 0:
        return "-" * m, b
    if m == 0:
        return a, "-" * n
    NEG = -10 ** 9
    M = np.full((n + 1, m + 1), NEG, np.int64)   # match/mismatch state
    X = np.full((n + 1, m + 1), NEG, np.int64)   # gap in b (consume a)
    Y = np.full((n + 1, m + 1), NEG, np.int64)   # gap in a (consume b)
    M[0, 0] = 0
    for i in range(1, n + 1):
        X[i, 0] = GAP_OPEN + GAP_EXTEND * (i - 1)
    for j in range(1, m + 1):
        Y[0, j] = GAP_OPEN + GAP_EXTEND * (j - 1)
    an = np.frombuffer(a.encode(), np.uint8)
    bn = np.frombuffer(b.encode(), np.uint8)
    jj = np.arange(1, m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        Mi1, Xi1, Yi1 = M[i - 1], X[i - 1], Y[i - 1]
        Mi, Xi, Yi = M[i], X[i], Y[i]
        Xi[1:] = np.maximum(Mi1[1:] + GAP_OPEN, Xi1[1:] + GAP_EXTEND)
        Xi[0] = max(Mi1[0] + GAP_OPEN, Xi1[0] + GAP_EXTEND)
        sub = np.where(an[i - 1] == bn, MATCH, MISMATCH)
        best_prev = np.maximum(np.maximum(Mi1[:-1], Xi1[:-1]), Yi1[:-1])
        Mi[1:] = best_prev + sub
        # the reference's loop over j, Y[i, j] = max(M[i, j-1] + GAP_OPEN,
        # X[i, j-1] + GAP_OPEN, Y[i, j-1] + GAP_EXTEND), unrolled: the best
        # opening at j' <= j extended to j (integers, so exact)
        opened = np.maximum(Mi[:-1], Xi[:-1]) + GAP_OPEN - GAP_EXTEND * jj
        Yi[1:] = GAP_EXTEND * jj + np.maximum(
            np.maximum.accumulate(opened), Yi[0])
    # traceback
    i, j = n, m
    state = int(np.argmax([M[n, m], X[n, m], Y[n, m]]))
    a_out, b_out = [], []
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            a_out.append(a[i - 1])
            b_out.append(b[j - 1])
            sub = MATCH if a[i - 1] == b[j - 1] else MISMATCH
            prev = [M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1]]
            state = int(np.argmax(prev))
            i, j = i - 1, j - 1
        elif state == 1 or j == 0:
            a_out.append(a[i - 1])
            b_out.append("-")
            if X[i, j] == M[i - 1, j] + GAP_OPEN or i == 1:
                state = 0
            else:
                state = 1
            i -= 1
        else:
            a_out.append("-")
            b_out.append(b[j - 1])
            if Y[i, j] == M[i, j - 1] + GAP_OPEN or j == 1:
                state = 0
            elif Y[i, j] == X[i, j - 1] + GAP_OPEN:
                state = 1
            else:
                state = 2
            j -= 1
    return "".join(reversed(a_out)), "".join(reversed(b_out))


def decompose(ref_slice: str, alt: str, pos0: int, ref_full: str,
              scoring: Scoring = DEFAULT):
    """Align alt against ref_slice and decompose into VCF-style records.

    pos0: 0-based position of ref_slice[0] in ref_full.  Returns list of
    (pos0based, REF, ALT) with anchor bases for indels, left-aligned
    (role of ref acall_decompose + left alignment)."""
    ra, aa = align(ref_slice, alt, scoring)
    records = []
    rpos = pos0
    i = 0
    L = len(ra)
    while i < L:
        if ra[i] != "-" and aa[i] != "-" and ra[i] == aa[i]:
            rpos += 1
            i += 1
            continue
        # variant run: extend while mismatching or gapped
        j = i
        while j < L and not (ra[j] != "-" and aa[j] != "-"
                             and ra[j] == aa[j]):
            j += 1
        refseq = ra[i:j].replace("-", "")
        altseq = aa[i:j].replace("-", "")
        vpos = rpos
        if len(refseq) != len(altseq) or len(refseq) == 0 or \
           len(altseq) == 0:
            # indel: add anchor base before
            anchor_pos = vpos - 1
            if anchor_pos < 0:
                i = j
                rpos += len(refseq)
                continue
            anchor = ref_full[anchor_pos]
            refseq = anchor + refseq
            altseq = anchor + altseq
            vpos = anchor_pos
            vpos, refseq, altseq = _left_align(ref_full, vpos, refseq,
                                               altseq)
        records.append((vpos, refseq, altseq))
        rpos += len(ra[i:j].replace("-", ""))
        i = j
    return records


def _left_align(ref_full: str, pos: int, refseq: str, altseq: str):
    """Shift an indel left while the last base equals the base before
    (standard VCF left alignment)."""
    while pos > 0 and len(refseq) != len(altseq) and \
            refseq[-1] == altseq[-1] and \
            ref_full[pos - 1] == refseq[-1]:
        pos -= 1
        base = ref_full[pos]
        refseq = base + refseq[:-1]
        altseq = base + altseq[:-1]
    return pos, refseq, altseq

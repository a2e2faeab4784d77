"""KOGraph: where each graph kmer occurs in a reference genome
(counterpart of mccortex_tpu/graph/kmer_occur.py).

Maps graph kmer rows to lists of (chrom, offset, strand) occurrences,
as a CSR over the store's rows built by one global sort of the
occurrences.  The reference's kmers are cut and made canonical on the
store's device (ops/kmer.rolling_kmers, canonical) and found through
the batched lookup (ops/hashidx.lookup: the lookup kernel on the card).

`orient`: 0 if the kmer's canonical key appears forward in the
reference at that offset, 1 if reverse complemented.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import CHAR_TO_BASE
from ..ops import hashidx
from ..ops import kmer as kops
from . import store as gstore


@dataclasses.dataclass
class KOGraph:
    offsets: torch.Tensor   # (capacity+1,) int32 CSR per kmer row
    chrom: torch.Tensor     # (L,) int32
    pos: torch.Tensor       # (L,) int64 0-based offset of kmer start
    orient: torch.Tensor    # (L,) uint8

    @property
    def noccurs(self) -> int:
        return self.chrom.shape[0]


@dataclasses.dataclass
class RefGenome:
    names: list
    seqs: list

    @classmethod
    def from_fasta(cls, path):
        from ..io import seqio
        names, seqs = [], []
        for rd in seqio.parse_reads(path):
            names.append(rd.name)
            seqs.append(rd.seq.upper())
        return cls(names, seqs)

    def as_dict(self) -> dict:
        """{name: sequence}, the map the CRAM reader rebuilds mapped
        records against."""
        return dict(zip(self.names, self.seqs))


def build_kograph(g: gstore.DBGraph, ref: RefGenome) -> KOGraph:
    """Index every reference kmer that exists in the graph.  The CSR
    lives on the host (numpy-backed CPU tensors): its readers walk it
    in Python."""
    rows_all, chroms_all, pos_all, or_all = [], [], [], []
    for ci, seq in enumerate(ref.seqs):
        arr = CHAR_TO_BASE[np.frombuffer(seq.encode(), np.uint8)]
        if len(arr) < g.k:
            continue
        bases = torch.from_numpy(arr[None]).to(g.device)
        kmers, valid = kops.rolling_kmers(bases, g.k)
        keys, orient = kops.canonical(kmers[0], g.k)
        idx, found = hashidx.lookup(g.keys, keys)
        hit = (valid[0] & found).cpu().numpy()
        p = np.nonzero(hit)[0]
        rows_all.append(idx.cpu().numpy()[p].astype(np.int64))
        chroms_all.append(np.full(len(p), ci, np.int32))
        pos_all.append(p.astype(np.int64))
        or_all.append(orient.cpu().numpy()[p])
    if not rows_all:
        return KOGraph(offsets=torch.zeros(g.capacity + 1, dtype=torch.int32),
                       chrom=torch.zeros(0, dtype=torch.int32),
                       pos=torch.zeros(0, dtype=torch.int64),
                       orient=torch.zeros(0, dtype=torch.uint8))
    rows = np.concatenate(rows_all)
    chroms = np.concatenate(chroms_all)
    poss = np.concatenate(pos_all)
    ors = np.concatenate(or_all)
    order = np.lexsort((poss, chroms, rows))
    rows, chroms, poss, ors = (rows[order], chroms[order], poss[order],
                               ors[order])
    counts = np.bincount(rows, minlength=g.capacity)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return KOGraph(offsets=torch.from_numpy(offsets),
                   chrom=torch.from_numpy(chroms),
                   pos=torch.from_numpy(poss),
                   orient=torch.from_numpy(ors.astype(np.uint8)))


def occurs(ko: KOGraph, rows: np.ndarray) -> np.ndarray:
    """True where the kmer row has >= 1 reference occurrence."""
    offs = ko.offsets.cpu().numpy()
    return offs[rows + 1] > offs[rows]


def occurs_mask(ko: KOGraph, N: int) -> np.ndarray:
    """(capacity,) True where a row has >= 1 occurrence (N is accepted
    for the JAX package's signature; the CSR fixes the length)."""
    return np.diff(ko.offsets.cpu().numpy()) > 0


def runs_of_path(ko: KOGraph, verts: np.ndarray, min_len: int = 1):
    """Colinear reference runs along a vertex path.

    verts: vertex (2*row+orient) sequence of a walked path.  Returns a
    list of dicts {chrom, first, last, strand, qoffset, len} where
    qoffset is the index in the path where the run starts; strand 0
    means reference positions increase along the path.

    The JAX package extends runs vertex by vertex in a dict; here every
    occurrence of every path vertex is laid out at once: an occurrence at
    path index q and reference offset p continues the run of the
    occurrence at q - 1 and p - 1 (strand 0) or p + 1 (strand 1), so a
    run is a stretch of consecutive q on one diagonal (chrom, strand,
    p -/+ q).  Same runs, same order.
    """
    offs = ko.offsets.cpu().numpy()
    verts = np.asarray(verts, np.int64)
    rows = verts >> 1
    start = offs[rows].astype(np.int64)
    cnt = offs[rows + 1].astype(np.int64) - start
    n = int(cnt.sum())
    if n == 0:
        return []
    q = np.repeat(np.arange(len(verts)), cnt)
    e = np.arange(n) - np.repeat(np.cumsum(cnt) - cnt, cnt) + \
        np.repeat(start, cnt)
    c = ko.chrom.cpu().numpy()[e].astype(np.int64)
    p = ko.pos.cpu().numpy()[e].astype(np.int64)
    # strand of each occurrence relative to the path direction:
    # occurrence orient is canonical key vs reference; vo is key vs path
    strand = ko.orient.cpu().numpy()[e].astype(np.int64) ^ (verts[q] & 1)
    diag = np.where(strand == 0, p - q, p + q)
    order = np.lexsort((q, diag, strand, c))
    q, c, p, strand, diag = (x[order] for x in (q, c, p, strand, diag))
    new = np.ones(n, bool)
    new[1:] = ((c[1:] != c[:-1]) | (strand[1:] != strand[:-1])
               | (diag[1:] != diag[:-1]) | (q[1:] != q[:-1] + 1))
    first = np.nonzero(new)[0]
    last = np.append(first[1:], n) - 1
    ln = last - first + 1
    keep = ln >= min_len
    first, last, ln = first[keep], last[keep], ln[keep]
    srt = np.lexsort((p[first], c[first], q[first]))
    return [{"chrom": cc, "first": pf, "last": pl, "strand": st,
             "qoffset": qq, "len": ll}
            for cc, pf, pl, st, qq, ll in zip(
                *(x[srt].tolist() for x in (c[first], p[first], p[last],
                                            strand[first], q[first], ln)))]

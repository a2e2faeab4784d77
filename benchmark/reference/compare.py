"""Comparisons that decide `correct`: each returns a count of records that
differ, so that an exact match reads 0.  The files are read with plain
code (a .ctx reader, text parsers for .ctp and FASTA), never with the
program's.
"""

from __future__ import annotations

import collections
import gzip
import json
import struct

import numpy as np

_COMP = str.maketrans("ACGT", "TGCA")


def read_ctx(path: str) -> tuple:
    """(keys (n, W) uint64, covg (n, C) uint32, edges (n, C) uint8) of a
    .ctx file (McCortex's graph format, version 6)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] != b"CORTEX":
        raise ValueError(f"{path}: not a .ctx file")
    version, k, W, C = struct.unpack_from("<4I", data, 6)
    if version != 6:
        raise ValueError(f"{path}: .ctx version {version}")
    off = 22 + 4 * C + 8 * C                 # read lengths, totals
    for _ in range(C):                       # sample names
        off += 4 + struct.unpack_from("<I", data, off)[0]
    off += 16 * C                            # error rates
    for _ in range(C):                       # cleaning records
        off += 12
        off += 4 + struct.unpack_from("<I", data, off)[0]
    if data[off:off + 6] != b"CORTEX":
        raise ValueError(f"{path}: bad .ctx header")
    rec = np.dtype([("kmer", "<u8", (W,)), ("covg", "<u4", (C,)),
                    ("edges", "u1", (C,))])
    body = np.frombuffer(data, rec, offset=off + 6)
    return (body["kmer"].reshape(-1, W).astype(np.uint64),
            body["covg"].reshape(-1, C).astype(np.uint32),
            body["edges"].reshape(-1, C).astype(np.uint8))


def records(keys, covg, edges) -> tuple:
    """A graph of one colour from torch (keys, covg, edges) int64
    tensors, in the form read_ctx gives."""
    return (keys.cpu().numpy().astype(np.uint64)[:, None],
            covg.cpu().numpy().astype(np.uint32)[:, None],
            edges.cpu().numpy().astype(np.uint8)[:, None])


def _key_ids(keys: np.ndarray) -> np.ndarray:
    """One sortable value a kmer: the word itself for one-word keys, a
    byte string of the words otherwise."""
    keys = np.ascontiguousarray(keys)
    if keys.shape[1] == 1:
        return keys[:, 0]
    return keys.view(np.dtype((np.void, 8 * keys.shape[1]))).reshape(-1)


def _repeats(ids: np.ndarray) -> int:
    """Kmers held more than once (a graph holds each kmer once)."""
    if ids.dtype == np.uint64:
        s = np.sort(ids)
        return int(np.count_nonzero(s[1:] == s[:-1]))
    return len(ids) - len(np.unique(ids))


def record_diff(got: tuple, want: tuple) -> int:
    """Kmers whose record (coverage and edges of every colour) differs
    between two graphs, that one graph holds and the other lacks, or that
    the program's graph holds twice."""
    gk, wk = _key_ids(got[0]), _key_ids(want[0])
    rep = _repeats(gk)
    _, gi, wi = np.intersect1d(gk, wk, assume_unique=rep == 0,
                               return_indices=True)
    differ = ((got[1][gi] != want[1][wi]).any(axis=1)
              | (got[2][gi] != want[2][wi]).any(axis=1))
    return int(len(gk) - len(gi) + len(wk) - len(wi) + differ.sum() + rep)


def read_fasta(path: str) -> list:
    seqs, cur = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


def _canon(s: str) -> str:
    rc = s.translate(_COMP)[::-1]
    return min(s, rc)


def unitig_diff(got: list, want: list) -> int:
    """Unitigs in one list and not the other, each taken in the lesser of
    its two orientations, as multisets (order and strand free)."""
    a = collections.Counter(map(_canon, got))
    b = collections.Counter(map(_canon, want))
    return sum(((a - b) + (b - a)).values())


def read_ctp(path: str) -> tuple:
    """(Counter of link records (kmer, F|R, junctions, counts, bases),
    {colour: {length: count}} of the header's contig histograms)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        text = fh.read()
    hdr, end = json.JSONDecoder().raw_decode(text)
    recs = collections.Counter()
    kmer = None
    for line in text[end:].splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] in ("F", "R"):
            recs[(kmer,) + tuple(parts)] += 1
        else:
            kmer = parts[0]
    hists = {}
    for c, h in enumerate(hdr.get("paths", {}).get("contig_hists", [])):
        hists[c] = dict(zip(h["lengths"], h["counts"]))
    return recs, hists


def links_diff(got: collections.Counter, want: collections.Counter) -> int:
    return sum(((got - want) + (want - got)).values())


def hist_diff(got: dict, want: dict) -> int:
    """Contig lengths whose counts differ, over every colour."""
    n = 0
    for c in set(got) | set(want):
        a, b = got.get(c, {}), want.get(c, {})
        n += sum(a.get(x, 0) != b.get(x, 0) for x in set(a) | set(b))
    return n

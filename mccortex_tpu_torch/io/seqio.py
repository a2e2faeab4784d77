"""Sequence file reading: FASTA / FASTQ, plain or gzipped.

Copy of the FASTA/FASTQ part of mccortex_tpu/io/seqio.py (which cannot
be imported without jax); tests hold the two equal.  The FASTQ quality
offset is an argument here instead of a module global.  Mate pairs
come as two files (read_batches_pe) or one interleaved file
(read_batches_interleaved), normalised to the FR convention.
SAM/BAM/CRAM input and the native C++ reader are not ported yet.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..constants import CHAR_TO_BASE


@dataclass
class Read:
    name: str
    seq: str
    quals: np.ndarray | None = None  # phred scores (int) or None


def _openseq(path):
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    return gzip.open(path, "rt") if gz else open(path, "rt")


def parse_reads(path: str, fq_offset: int = 0) -> Iterator[Read]:
    """Yield reads from FASTA/FASTQ (gz ok).  fq_offset: FASTQ quality
    ASCII offset, 33 or 64; 0 = auto-detect from the first record."""
    with _openseq(path) as fh:
        first = fh.readline()
        if not first:
            return
        if "\t" in first:
            raise ValueError(f"{path}: SAM input is not ported yet")
        if first.startswith(">"):
            name, chunks = first[1:].strip(), []
            for line in fh:
                if line.startswith(">"):
                    yield Read(name.split()[0] if name else "",
                               "".join(chunks).upper())
                    name, chunks = line[1:].strip(), []
                else:
                    chunks.append(line.strip())
            yield Read(name.split()[0] if name else "", "".join(chunks).upper())
        elif first.startswith("@"):
            name = first
            offset = fq_offset
            while name:
                seq = fh.readline().strip().upper()
                fh.readline()  # '+' separator
                qual = fh.readline().strip()
                qb = np.frombuffer(qual.encode(), np.uint8)
                if offset == 0:
                    # any char below '@' implies phred+33; otherwise
                    # phred+64 (Illumina 1.3-1.7)
                    offset = 33 if (len(qb) == 0 or qb.min() < 64) else 64
                quals = qb.astype(np.int16) - offset
                yield Read(name[1:].strip().split()[0], seq,
                           np.clip(quals, 0, 255).astype(np.uint8))
                name = fh.readline()
        else:
            raise ValueError(f"{path}: unrecognised sequence format "
                             f"(BAM/CRAM input is not ported yet)")


def read_batches(paths, batch_size: int = 2048, max_len: int | None = None,
                 colour: int = 0, fq_offset: int = 0) -> Iterator[tuple]:
    """Group reads into (codes (B, L) uint8, quals (B, L) uint8 | None,
    colour) batches, padded with the invalid code 4.  With max_len=None
    rows size to the longest read; with max_len, reads are CLIPPED to it
    (read_batches_chunked splits long records instead)."""
    buf = []
    for path in paths:
        for rd in parse_reads(path, fq_offset):
            buf.append(rd)
            if len(buf) >= batch_size:
                yield _to_batch(buf, max_len, colour)
                buf = []
    if buf:
        yield _to_batch(buf, max_len, colour)


def _to_batch(reads, max_len, colour):
    L = max(len(r.seq) for r in reads)
    if max_len:
        L = min(L, max_len)
    L = max(L, 1)
    B = len(reads)
    codes = np.full((B, L), 4, dtype=np.uint8)
    any_quals = any(r.quals is not None for r in reads)
    quals = np.zeros((B, L), dtype=np.uint8) if any_quals else None
    for i, r in enumerate(reads):
        s = np.frombuffer(r.seq[:L].encode(), np.uint8)
        codes[i, :len(s)] = CHAR_TO_BASE[s]
        if quals is not None and r.quals is not None:
            q = r.quals[:L]
            quals[i, :len(q)] = q
    return codes, quals, colour


def _chunk_read(rd: Read, max_len: int, overlap: int):
    """Split one long read into chunks of max_len that overlap by
    `overlap` bases."""
    L = len(rd.seq)
    if L <= max_len:
        yield rd
        return
    step = max(max_len - overlap, 1)
    off = 0
    while True:
        end = min(off + max_len, L)
        yield Read(rd.name, rd.seq[off:end],
                   rd.quals[off:end] if rd.quals is not None else None)
        if end >= L:
            return
        off += step


def read_batches_chunked(paths, batch_size: int = 2048, max_len: int = 1024,
                         colour: int = 0, overlap: int = 64,
                         fq_offset: int = 0):
    """Batches as read_batches, but records longer than max_len are
    emitted as overlapping row chunks (never truncated); with overlap=k
    each seam repeats exactly one kmer observation."""
    buf = []
    for path in paths:
        for rd in parse_reads(path, fq_offset):
            for ch in _chunk_read(rd, max_len, overlap):
                buf.append(ch)
                if len(buf) >= batch_size:
                    yield _to_batch(buf, max_len, colour)
                    buf = []
    if buf:
        yield _to_batch(buf, max_len, colour)


def _rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a padded code batch (4 = invalid stays 4)."""
    return np.where(codes < 4, 3 - codes, 4).astype(np.uint8)[:, ::-1]


def mate_normalize(c1: np.ndarray, c2: np.ndarray, matedir: str = "FR",
                   q1: np.ndarray | None = None,
                   q2: np.ndarray | None = None):
    """Normalise a mate pair to the FR convention every paired consumer
    assumes (r1 fragment-forward, r2 on the reverse strand).  Only the
    mates' relative orientation matters: RR equals FF, RF is the
    mirrored FR.  Quality rows are reversed alongside their codes.
    Returns (c1, c2), or (c1, c2, q1, q2) when a quality array is given."""
    m = matedir.upper()
    if m == "FR":
        pass
    elif m in ("FF", "RR"):
        c2 = _rc_codes(c2)
        q2 = q2[:, ::-1] if q2 is not None else None
    elif m == "RF":
        c1, c2 = _rc_codes(c1), _rc_codes(c2)
        q1 = q1[:, ::-1] if q1 is not None else None
        q2 = q2[:, ::-1] if q2 is not None else None
    else:
        raise ValueError(f"matepair must be FF/FR/RF/RR, got {matedir!r}")
    if q1 is None and q2 is None:
        return c1, c2
    return c1, c2, q1, q2


def read_batches_pe(path1, path2, batch_size: int = 2048,
                    max_len: int = 8192, colour: int = 0,
                    matedir: str = "FR", fq_offset: int = 0):
    """Yield mate-pair batches (codes1, codes2, colour); the files hold
    the mates in the same order.  A mate of max_len bases or more would
    come as several chunk rows and misalign the pairing, so it is
    rejected."""
    it1 = read_batches_chunked([path1], batch_size, max_len, colour,
                               fq_offset=fq_offset)
    it2 = read_batches_chunked([path2], batch_size, max_len, colour,
                               fq_offset=fq_offset)
    for (c1, _q1, _), (c2, _q2, _) in zip(it1, it2):
        if c1.shape[1] >= max_len or c2.shape[1] >= max_len:
            raise ValueError(
                f"paired-end mate >= {max_len}bp: chunked rows would "
                f"misalign mate pairing ({path1} / {path2})")
        n = min(c1.shape[0], c2.shape[0])
        c1, c2 = mate_normalize(c1[:n], c2[:n], matedir)
        yield c1, c2, colour


def read_batches_interleaved(path, batch_size: int = 2048,
                             max_len: int = 8192, colour: int = 0,
                             matedir: str = "FR", fq_offset: int = 0):
    """Yield (codes1, codes2, quals1, quals2, colour) from an interleaved
    mate-pair file (even rows = r1); the same length guard as
    read_batches_pe."""
    for codes, quals, _ in read_batches_chunked([path], batch_size, max_len,
                                                colour, fq_offset=fq_offset):
        if codes.shape[1] >= max_len:
            raise ValueError(
                f"interleaved mate >= {max_len}bp: chunked rows would "
                f"misalign mate pairing ({path})")
        if codes.shape[0] % 2:
            codes = codes[:-1]
            quals = quals[:-1] if quals is not None else None
        c1, c2 = codes[0::2], codes[1::2]
        q1 = quals[0::2] if quals is not None else None
        q2 = quals[1::2] if quals is not None else None
        c1, c2, q1, q2 = mate_normalize(
            c1, c2, matedir,
            q1 if q1 is not None else np.zeros_like(c1),
            q2 if q2 is not None else np.zeros_like(c2))
        if quals is None:
            q1 = q2 = None
        yield c1, c2, q1, q2, colour

"""Sequence file reading: FASTA / FASTQ, plain or gzipped.

Copy of the FASTA/FASTQ part of mccortex_tpu/io/seqio.py (which cannot
be imported without jax); tests hold the two equal.  The FASTQ quality
offset is an argument here instead of a module global.  SAM/BAM/CRAM
input and the native C++ reader are not ported yet.
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

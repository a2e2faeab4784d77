"""Sequence file reading: FASTA, FASTQ, SAM, BAM and CRAM, plain or
gzipped (BGZF for BAM).

Counterpart of mccortex_tpu/io/seqio.py, which cannot be imported
without jax; tests hold the two equal.  Differences from it:

- the FASTQ quality offset (`fq_offset`) and the CRAM reference
  (`cram_ref`, a {name: seq} map or a RefGenome) are arguments, not
  module globals;
- every reader follows the native reader's rule for qualities: a batch
  whose qualities are all zero comes out with `quals=None`; the
  chunking readers give an empty record no row;
- the prefetch thread of `read_batches_native` always delivers its end
  marker, also when the queue is full at the end of the input.

Both batch readers parse in the C++ parser of `mccortex_tpu_torch/native`
(FASTA/FASTQ/SAM/BAM; CRAM decodes in Python), or in the Python parser
`parse_reads` when the library cannot be built; both parsers give the
same batches.  `read_batches_native` is `build`'s: long records split
into overlapping rows, a batch never spanning two files.
`read_batches` is `thread`'s, `contigs --seed`'s and `subgraph`'s:
whole records, batches that span files.  Mate pairs come as two files
(read_batches_pe) or one interleaved file (read_batches_interleaved),
normalised to the FR convention.
"""

from __future__ import annotations

import contextlib
import ctypes
import gzip
import itertools
import os
import queue
import struct
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .. import native as _native
from ..constants import CHAR_TO_BASE
from ..utils import timing


@dataclass
class Read:
    name: str
    seq: str
    quals: np.ndarray | None = None  # phred scores (int) or None


def _openseq(path):
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    return gzip.open(path, "rt") if gz else open(path, "rt")


def _is_cram(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"CRAM"


def _is_bam(path: str) -> bool:
    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return False
    with gzip.open(path, "rb") as g:
        return g.read(4) == b"BAM\x01"


def _phred(qchars: bytes, offset: int, n: int) -> np.ndarray:
    """Quality characters -> phred scores, clipped to [0, 255] and to
    the n bases of the record."""
    q = np.frombuffer(qchars[:n], np.uint8).astype(np.int16) - offset
    return np.clip(q, 0, 255).astype(np.uint8)


def parse_reads(path: str, fq_offset: int = 0,
                cram_ref=None) -> Iterator[Read]:
    """Yield reads from FASTA/FASTQ/SAM/BAM/CRAM (gz/BGZF ok); the format
    is detected from the content.  fq_offset: FASTQ quality ASCII
    offset, 33 or 64; 0 = auto-detect from the first record.  cram_ref:
    the reference sequences mapped CRAM records are rebuilt against.
    Secondary and supplementary alignments are skipped."""
    if _is_cram(path):
        from .cram import parse_cram
        for name, seq, quals in parse_cram(path, ref=cram_ref):
            yield Read(name, seq.upper(), quals)
        return
    if _is_bam(path):
        yield from _parse_bam(path)
        return
    with _openseq(path) as fh:
        first = fh.readline()
        if not first:
            return
        if "\t" in first:          # SAM (with or without @-header)
            yield from _parse_sam_lines(first, fh)
            return
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
                qual = fh.readline().strip().encode()
                if offset == 0:
                    # any char below '@' implies phred+33; otherwise
                    # phred+64 (Illumina 1.3-1.7)
                    offset = 33 if (not qual or min(qual) < 64) else 64
                yield Read(name[1:].strip().split()[0], seq,
                           _phred(qual, offset, len(seq)))
                name = fh.readline()
        else:
            raise ValueError(f"{path}: unrecognised sequence format")


def _parse_sam_lines(first: str, fh) -> Iterator[Read]:
    """SAM text records (header lines skipped; 0x100/0x800 flags and
    SEQ='*' records dropped)."""
    for line in itertools.chain([first], fh):
        if not line.strip() or line.startswith("@"):
            continue
        f = line.rstrip("\r\n").split("\t")
        if len(f) < 11:
            continue
        flag = int(f[1])
        if flag & 0x900 or f[9] == "*":
            continue
        quals = None
        if f[10] != "*":
            quals = _phred(f[10].encode(), 33, len(f[9]))
        yield Read(f[0], f[9].upper(), quals)


_BAM_SEQ = "=ACMGRSVTWYHKDBN"


def _bam_header(g, path) -> list:
    """Read a BAM stream's magic and header; returns the reference
    names."""
    if g.read(4) != b"BAM\x01":
        raise ValueError(f"{path}: bad BAM magic")
    (l_text,) = struct.unpack("<i", g.read(4))
    g.read(l_text)
    (n_ref,) = struct.unpack("<i", g.read(4))
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", g.read(4))
        names.append(g.read(l_name)[:-1].decode())
        g.read(4)  # l_ref
    return names


def _bam_records(g, path) -> Iterator[bytes]:
    while True:
        bs = g.read(4)
        if len(bs) < 4:
            return
        (block_size,) = struct.unpack("<i", bs)
        rec = g.read(block_size)
        if len(rec) < block_size:
            raise ValueError(f"{path}: truncated BAM record")
        yield rec


def _parse_bam(path: str) -> Iterator[Read]:
    """Minimal BAM reader: BGZF is concatenated gzip members, which
    Python's gzip module reads transparently.  A quality of 0xFF (absent)
    reads as 0, as in the native reader."""
    with gzip.open(path, "rb") as g:
        _bam_header(g, path)
        for rec in _bam_records(g, path):
            l_read_name = rec[8]
            n_cigar, flag = struct.unpack("<HH", rec[12:16])
            (l_seq,) = struct.unpack("<i", rec[16:20])
            if flag & 0x900 or l_seq <= 0:
                continue
            name = rec[32:32 + l_read_name - 1].decode()
            off = 32 + l_read_name + 4 * n_cigar
            nseq = (l_seq + 1) // 2
            s4 = np.frombuffer(rec[off:off + nseq], np.uint8)
            nib = np.empty(nseq * 2, np.uint8)
            nib[0::2] = s4 >> 4
            nib[1::2] = s4 & 0xF
            seq = "".join(_BAM_SEQ[x] for x in nib[:l_seq])
            qual = np.frombuffer(
                rec[off + nseq:off + nseq + l_seq], np.uint8)
            quals = None if (qual == 0xFF).all() else \
                np.where(qual == 0xFF, 0, qual).astype(np.uint8)
            yield Read(name, seq, quals)


# reference-consuming CIGAR operations: M=0, D=2, N=3, '='=7, X=8
_REF_CONSUMES = (1, 0, 1, 1, 0, 0, 0, 1, 1)


def parse_bam_alignments(path: str):
    """Yield (name, flag, rname, pos0, mapq, ref_len) per BAM record: the
    alignment fields (RNAME through the header's reference table, POS,
    MAPQ, the reference span from the CIGAR) that _parse_bam skips."""
    with gzip.open(path, "rb") as g:
        ref_names = _bam_header(g, path)
        for rec in _bam_records(g, path):
            ref_id, pos0 = struct.unpack("<ii", rec[0:8])
            l_read_name = rec[8]
            mapq = rec[9]
            n_cigar, flag = struct.unpack("<HH", rec[12:16])
            name = rec[32:32 + l_read_name - 1].decode()
            coff = 32 + l_read_name
            ref_len = 0
            for cv in struct.unpack(f"<{n_cigar}I",
                                    rec[coff:coff + 4 * n_cigar]):
                op = cv & 0xF
                if op < 9 and _REF_CONSUMES[op]:
                    ref_len += cv >> 4
            rname = ref_names[ref_id] if 0 <= ref_id < len(ref_names) \
                else "*"
            yield (name, flag, rname, pos0, mapq, ref_len)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def read_batches(paths, batch_size: int = 2048, max_len: int | None = None,
                 colour: int = 0, fq_offset: int = 0,
                 cram_ref=None) -> Iterator[tuple]:
    """Group reads into (codes (B, L) uint8, quals (B, L) uint8 | None,
    colour) batches of batch_size reads, padded with the invalid code 4;
    a batch holds reads of consecutive files.  With max_len=None rows
    size to the longest read; with max_len, reads are CLIPPED to it
    (read_batches_native splits long records instead).  An empty record
    is a row of 4s.

    Each file parses in the C++ parser (whole records, by parse_reads'
    rules) when the library is loaded and the file is not CRAM, else in
    parse_reads: the same batches.  Counters `read.native` and
    `read.python` count the reads of each."""
    lib = _native.get_lib()
    held, n = [], 0        # pieces of the batch being filled, their reads
    for path in paths:
        native = lib is not None and not _is_cram(path)
        pieces = (_native_records(lib, path, batch_size, fq_offset)
                  if native else
                  _python_records(path, batch_size, fq_offset, cram_ref))
        with contextlib.closing(pieces):
            for lens, codes, quals in pieces:
                timing.count("read.native", len(lens) if native else 0)
                timing.count("read.python", 0 if native else len(lens))
                while len(lens):
                    take = min(batch_size - n, len(lens))
                    nb = int(lens[:take].sum())
                    held.append((lens[:take], codes[:nb], quals[:nb]))
                    lens, codes, quals = lens[take:], codes[nb:], quals[nb:]
                    n += take
                    if n == batch_size:
                        yield _pad(held, max_len, colour)
                        held, n = [], 0
    if held:
        yield _pad(held, max_len, colour)


def _native_records(lib, path, batch_size, fq_offset):
    """(lens, codes, quals) pieces of up to batch_size whole records of
    one file from the C++ parser: record i's bases and phred scores
    follow record i - 1's in the flat codes and quals."""
    h = lib.mctx_seq_open(os.fsencode(path), int(fq_offset), 0)
    if not h:
        raise FileNotFoundError(path)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    cap = batch_size * 256
    try:
        while True:
            codes = np.empty(cap, np.uint8)
            quals = np.empty(cap, np.uint8)
            lens = np.empty(batch_size, np.int32)
            n = lib.mctx_seq_read_records(
                h, batch_size, cap, codes.ctypes.data_as(u8),
                quals.ctypes.data_as(u8),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n == -2:                 # a record longer than the buffer
                cap = max(2 * cap, int(lens[0]))
                continue
            if n < 0:
                raise ValueError(f"{path}: native parse error")
            if n == 0:
                return
            total = int(lens[:n].sum())
            yield lens[:n], codes[:total], quals[:total]
    finally:
        lib.mctx_seq_close(h)


def _python_records(path, batch_size, fq_offset, cram_ref):
    """_native_records' pieces from parse_reads."""
    reads = parse_reads(path, fq_offset, cram_ref)
    while chunk := list(itertools.islice(reads, batch_size)):
        yield _piece(chunk)


def _piece(reads):
    """(lens, codes, quals) of a list of Reads, flat as _native_records
    gives them (0 where a read has no quality)."""
    lens = np.array([len(r.seq) for r in reads], np.int32)
    codes = CHAR_TO_BASE[np.frombuffer(
        "".join(r.seq for r in reads).encode(), np.uint8)]
    quals = np.zeros(len(codes), np.uint8)
    for r, end, n in zip(reads, np.cumsum(lens), lens):
        if r.quals is not None:
            q = r.quals[:n]
            quals[end - n:end - n + len(q)] = q
    return lens, codes, quals


def _pad(held, max_len, colour):
    """One batch from the held pieces: rows padded with 4 to the longest
    record, clipped to max_len."""
    lens, codes, quals = (np.concatenate(x) for x in zip(*held))
    if max_len and lens.max() > max_len:
        at = np.arange(len(codes)) - np.repeat(np.cumsum(lens) - lens, lens)
        keep = at < max_len
        lens, codes, quals = np.minimum(lens, max_len), codes[keep], \
            quals[keep]
    B, L = len(lens), max(int(lens.max()), 1)
    if (lens == L).all():       # reads of one length: no padding
        rows, q = codes.reshape(B, L), quals.reshape(B, L)
    else:
        inside = np.arange(L) < lens[:, None]
        rows = np.full((B, L), 4, np.uint8)
        rows[inside] = codes
        q = np.zeros((B, L), np.uint8)
        q[inside] = quals
    # the native reader's rule: no quality above 0, no quality array
    return rows, (q if q.any() else None), colour


def _chunk_read(rd: Read, max_len: int, overlap: int):
    """Split one long read into chunks of max_len that overlap by
    `overlap` bases; an empty read gives none (as in the native
    reader)."""
    L = len(rd.seq)
    if L <= max_len:
        if L:
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
                         fq_offset: int = 0, cram_ref=None):
    """Batches as read_batches, but records longer than max_len are
    emitted as overlapping row chunks (never truncated); with overlap=k
    each seam repeats exactly one kmer observation.  A batch may hold
    reads of several files (read_batches_native's never do)."""
    buf = []
    for path in paths:
        for rd in parse_reads(path, fq_offset, cram_ref):
            for ch in _chunk_read(rd, max_len, overlap):
                buf.append(ch)
                if len(buf) >= batch_size:
                    yield _pad([_piece(buf)], max_len, colour)
                    buf = []
    if buf:
        yield _pad([_piece(buf)], max_len, colour)


def reader_name() -> str:
    """Which parser the batch readers run on files other than CRAM:
    "native" when the C++ library is built and loaded, else "python"."""
    return "python" if _native.get_lib() is None else "native"


def read_batches_native(paths, batch_size: int = 2048, max_len: int = 1024,
                        colour: int = 0, prefetch: int = 4,
                        overlap: int | None = None, fq_offset: int = 0,
                        cram_ref=None):
    """The build's reader: (codes, quals, colour) batches as
    read_batches_chunked, one file at a time (a batch never spans two
    files), from the C++ parser, or from the Python parser when the
    native library is unavailable (the same batches).  CRAM decodes in
    Python on both paths.

    Records longer than max_len come as overlapping row chunks: each
    seam shares `overlap` bases [default 64, enough for any k <= 63];
    callers that know k pass overlap=k.

    prefetch > 0 decodes on a producer thread through a queue of that
    many batches, so file IO and parsing overlap the caller's work (the
    C++ parser runs without the interpreter lock).  An abandoned
    generator stops its producer and joins it."""
    args = (paths, batch_size, max_len, colour, 0, overlap, fq_offset,
            cram_ref)
    if prefetch > 0:
        yield from _prefetched(lambda: read_batches_native(*args), prefetch)
        return
    ov = int(overlap or 64)
    lib = _native.get_lib()
    for path in paths:
        if lib is None or _is_cram(path):
            yield from read_batches_chunked([path], batch_size, max_len,
                                            colour, ov, fq_offset, cram_ref)
            continue
        yield from _native_batches(lib, path, batch_size, max_len, colour,
                                   ov, fq_offset)


def _native_batches(lib, path, batch_size, max_len, colour, overlap,
                    fq_offset):
    h = lib.mctx_seq_open(os.fsencode(path), int(fq_offset), int(overlap))
    if not h:
        raise FileNotFoundError(path)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    try:
        while True:
            # the parser fills every byte of the three buffers
            codes = np.empty((batch_size, max_len), np.uint8)
            quals = np.empty((batch_size, max_len), np.uint8)
            lens = np.empty(batch_size, np.int32)
            n = lib.mctx_seq_read_batch(
                h, batch_size, max_len, codes.ctypes.data_as(u8),
                quals.ctypes.data_as(u8),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n < 0:
                raise ValueError(f"{path}: native parse error")
            if n == 0:
                break
            L = int(min(max(lens[:n].max(), 1), max_len))
            q = quals[:n, :L]
            yield (np.ascontiguousarray(codes[:n, :L]),
                   np.ascontiguousarray(q) if q.any() else None, colour)
    finally:
        lib.mctx_seq_close(h)


def _prefetched(make, depth: int):
    """Iterate make() on a producer thread through a queue of `depth`
    items.  The end marker is put like any item (waiting for room), so
    it is never lost; closing the consumer stops the producer, closes
    its generator and joins it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with contextlib.closing(make()) as it:
                for item in it:
                    if not put(item):
                        return
        except Exception as e:      # raised again on the consumer's side
            err.append(e)
        finally:
            put(end)

    t = threading.Thread(target=produce, daemon=True,
                         name="mctx-seq-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            yield item
    finally:
        stop.set()
        t.join()
    if err:
        raise err[0]


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
                    matedir: str = "FR", fq_offset: int = 0, cram_ref=None):
    """Yield mate-pair batches (codes1, codes2, colour) from two files
    read at once by read_batches_native, each on its own prefetch
    thread; the files hold the mates in the same order.  A mate of
    max_len bases or more would come as several chunk rows and misalign
    the pairing, so it is rejected."""
    it1 = read_batches_native([path1], batch_size, max_len, colour,
                              fq_offset=fq_offset, cram_ref=cram_ref)
    it2 = read_batches_native([path2], batch_size, max_len, colour,
                              fq_offset=fq_offset, cram_ref=cram_ref)
    with contextlib.closing(it1), contextlib.closing(it2):
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
                             matedir: str = "FR", fq_offset: int = 0,
                             cram_ref=None):
    """Yield (codes1, codes2, quals1, quals2, colour) from an interleaved
    mate-pair file (even rows = r1); the same length guard as
    read_batches_pe."""
    it = read_batches_native([path], batch_size, max_len, colour,
                             fq_offset=fq_offset, cram_ref=cram_ref)
    with contextlib.closing(it):
        for codes, quals, _ in it:
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

"""`.ctx` graph file IO — byte-compatible with the reference v6 format.

Copy of the writer, reader and header classes of mccortex_tpu/io/ctx.py
(which cannot be imported without jax); tests hold the two equal.

Spec: ref docs/file_formats/graph_file_format.txt and
src/graph/graph_file_reader.c:88-210 / graph_writer.c.  Layout:

  "CORTEX" | u32 version=6 | u32 kmer_size | u32 W | u32 ncols
  | u32 mean_read_len × ncols | u64 total_seq × ncols
  | per colour: u32 name_len + bytes
  | long double seq_err × ncols          (x86-64: 16 bytes, 80-bit ext.)
  | per colour: u8 cleaned_tips, u8 cleaned_unitigs, u8 cleaned_kmers,
      u8 is_graph_intersection, u32 clean_unitigs_thresh,
      u32 clean_kmers_thresh, u32 len + bytes (intersection name)
  | "CORTEX"
  | records: W×u64 kmer | ncols×u32 covg | ncols×u8 edges

All integers little-endian.  Gzip-wrapped files are accepted on read.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import os
import struct
from typing import BinaryIO

import numpy as np

from ..constants import nwords

MAGIC = b"CORTEX"
VERSION = 6


@dataclasses.dataclass
class ErrorCleaning:
    """Per-colour cleaning history (ref: graph_info.h ErrorCleaning)."""
    cleaned_tips: bool = False
    cleaned_unitigs: bool = False
    cleaned_kmers: bool = False
    is_graph_intersection: bool = False
    clean_unitigs_thresh: int = 0
    clean_kmers_thresh: int = 0
    intersection_name: str = "undefined"


@dataclasses.dataclass
class GraphInfo:
    """Per-colour metadata (ref: src/basic/graph_info.h)."""
    sample_name: str = "undefined"
    total_sequence: int = 0
    mean_read_length: int = 0
    seq_err: float = 0.01
    cleaning: ErrorCleaning = dataclasses.field(default_factory=ErrorCleaning)


@dataclasses.dataclass
class CtxHeader:
    kmer_size: int
    ginfo: list  # [GraphInfo] per colour
    version: int = VERSION

    @property
    def ncols(self) -> int:
        return len(self.ginfo)

    @property
    def W(self) -> int:
        return nwords(self.kmer_size)


def _open_maybe_gz(path) -> BinaryIO:
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    return gzip.open(path) if gz else open(path, "rb")  # type: ignore


def _pack_longdouble(x: float) -> bytes:
    # 16 bytes on x86-64: 10-byte x87 extended value + 6 padding bytes.
    # numpy leaves the padding uninitialised, which makes .ctx files
    # non-reproducible byte-for-byte; zero it (readers ignore it).
    b = np.longdouble(x).tobytes()
    return b[:10] + b"\x00" * (len(b) - 10)


def _unpack_longdouble(b: bytes) -> float:
    return float(np.frombuffer(b, dtype=np.longdouble, count=1)[0])


def write_header(fh: BinaryIO, h: CtxHeader) -> None:
    fh.write(MAGIC)
    fh.write(struct.pack("<4I", h.version, h.kmer_size, h.W, h.ncols))
    for gi in h.ginfo:
        fh.write(struct.pack("<I", gi.mean_read_length))
    for gi in h.ginfo:
        fh.write(struct.pack("<Q", gi.total_sequence))
    for gi in h.ginfo:
        name = gi.sample_name.encode()
        fh.write(struct.pack("<I", len(name)) + name)
    for gi in h.ginfo:
        fh.write(_pack_longdouble(gi.seq_err))
    for gi in h.ginfo:
        ec = gi.cleaning
        fh.write(struct.pack("<4B", ec.cleaned_tips, ec.cleaned_unitigs,
                             ec.cleaned_kmers, ec.is_graph_intersection))
        fh.write(struct.pack("<2I", ec.clean_unitigs_thresh,
                             ec.clean_kmers_thresh))
        nm = ec.intersection_name.encode()
        fh.write(struct.pack("<I", len(nm)) + nm)
    fh.write(MAGIC)


def read_header(fh: BinaryIO) -> CtxHeader:
    magic = fh.read(6)
    if magic != MAGIC:
        raise ValueError(f"not a .ctx file (bad magic {magic!r})")
    version, ksize, W, ncols = struct.unpack("<4I", fh.read(16))
    if version != VERSION:
        raise ValueError(f"unsupported .ctx version {version} (only v6)")
    if W != nwords(ksize):
        raise ValueError(f"header W={W} != nwords({ksize})")
    ginfo = [GraphInfo() for _ in range(ncols)]
    for gi in ginfo:
        gi.mean_read_length = struct.unpack("<I", fh.read(4))[0]
    for gi in ginfo:
        gi.total_sequence = struct.unpack("<Q", fh.read(8))[0]
    for gi in ginfo:
        ln = struct.unpack("<I", fh.read(4))[0]
        gi.sample_name = fh.read(ln).decode(errors="replace")
    for gi in ginfo:
        gi.seq_err = _unpack_longdouble(fh.read(16))
    for gi in ginfo:
        ec = gi.cleaning
        (ec.cleaned_tips, ec.cleaned_unitigs, ec.cleaned_kmers,
         ec.is_graph_intersection) = \
            [bool(x) for x in struct.unpack("<4B", fh.read(4))]
        ec.clean_unitigs_thresh, ec.clean_kmers_thresh = \
            struct.unpack("<2I", fh.read(8))
        ln = struct.unpack("<I", fh.read(4))[0]
        ec.intersection_name = fh.read(ln).decode(errors="replace")
    if fh.read(6) != MAGIC:
        raise ValueError("corrupt .ctx header (missing closing magic)")
    return CtxHeader(kmer_size=ksize, ginfo=ginfo, version=version)


def write_ctx(path: str, header: CtxHeader, keys: np.ndarray,
              covg: np.ndarray, edges: np.ndarray) -> None:
    """keys (N, W) uint64 (any order; callers usually pass sorted — our
    store is always sorted, which makes every output a valid input for
    `ctx sort`-dependent tools for free); covg (N, C) u32; edges (N, C) u8.
    Kmers with all-zero covg are dropped (reader rejects them,
    ref graph_file_reader.c 'kmer with zero covg')."""
    keys = np.ascontiguousarray(keys, dtype="<u8")
    covg = np.ascontiguousarray(covg, dtype="<u4")
    edges = np.ascontiguousarray(edges, dtype="u1")
    keep = covg.sum(axis=1) > 0
    keys, covg, edges = keys[keep], covg[keep], edges[keep]
    N, W = keys.shape
    C = covg.shape[1]
    rec = np.zeros(N, dtype=np.dtype(
        [("kmer", "<u8", (W,)), ("covg", "<u4", (C,)), ("edges", "u1", (C,))]))
    rec["kmer"], rec["covg"], rec["edges"] = keys, covg, edges
    with open(path, "wb") as fh:
        write_header(fh, header)
        fh.write(rec.tobytes())


def read_ctx(path: str):
    """Returns (header, keys (N,W) u64, covg (N,C) u32, edges (N,C) u8)."""
    with _open_maybe_gz(path) as fh:
        h = read_header(fh)
        body = fh.read()
    W, C = h.W, h.ncols
    rec_dt = np.dtype(
        [("kmer", "<u8", (W,)), ("covg", "<u4", (C,)), ("edges", "u1", (C,))])
    if len(body) % rec_dt.itemsize:
        raise ValueError(
            f"truncated .ctx: {len(body)} bytes not a multiple of record "
            f"size {rec_dt.itemsize}")
    rec = np.frombuffer(body, dtype=rec_dt)
    return (h, rec["kmer"].astype(np.uint64).reshape(-1, W),
            rec["covg"].astype(np.uint32).reshape(-1, C),
            rec["edges"].astype(np.uint8).reshape(-1, C))


class DiskGraphReader:
    """Kmer lookup on a SORTED uncompressed .ctx file on disk, through the
    `.idx` block index that `index` writes (ref src/graph/graph_search.h
    disk binary search; ctx_server.c --disk).  Without an index file,
    every 4096th record starts a block.  Memory is one key a block; a
    query reads one block of records and binary-searches it.  Host numpy,
    copied from mccortex_tpu/io/ctx.py (the block keys' sortable form is
    made once here, not at every query)."""

    def __init__(self, path: str, idx_path: str | None = None,
                 block_kmers: int = 4096):
        self.fh = open(path, "rb")
        try:
            self._open(path, idx_path or (path + ".idx"), block_kmers,
                       os.path.getsize(path))
        except BaseException:
            self.fh.close()
            raise

    def _open(self, path, idx_path, block_kmers, size):
        self.h = read_header(self.fh)
        self.data_off = self.fh.tell()
        W, C = self.h.W, self.h.ncols
        self.rec_dt = np.dtype([("kmer", "<u8", (W,)),
                                ("covg", "<u4", (C,)),
                                ("edges", "u1", (C,))])
        if (size - self.data_off) % self.rec_dt.itemsize:
            raise ValueError(f"{path}: truncated .ctx")
        self.n = (size - self.data_off) // self.rec_dt.itemsize
        starts, keys = [], []
        if os.path.exists(idx_path):
            from ..utils import npkmer as npk
            with open(idx_path) as fh:
                for line in fh:
                    if line.startswith("#") or not line.strip():
                        continue
                    kstr, index, _nk = line.split("\t")
                    kk, _, _ = npk.seq_canonical_keys(kstr.strip(),
                                                      self.h.kmer_size)
                    starts.append(int(index))
                    keys.append(kk[0])
        else:
            for s in range(0, self.n, block_kmers):
                self.fh.seek(self.data_off + s * self.rec_dt.itemsize)
                rec = np.frombuffer(
                    self.fh.read(self.rec_dt.itemsize), self.rec_dt)
                starts.append(s)
                keys.append(rec["kmer"][0].astype(np.uint64))
        self.block_starts = np.array(starts, np.int64)
        if keys:
            self.block_keys = np.stack(keys).astype(np.uint64)
        else:
            self.block_keys = np.zeros((0, W), np.uint64)
        from ..calls.calls2vcf import _key_void
        self._block_void = _key_void(self.block_keys)

    def lookup(self, key: np.ndarray):
        """key: (W,) uint64 canonical.  Returns (row, covg, edges) or
        None."""
        from ..calls.calls2vcf import _key_void
        if self.n == 0:
            return None
        qv = _key_void(key[None])[0]
        b = int(np.searchsorted(self._block_void, qv, side="right")) - 1
        if b < 0:
            return None
        s = int(self.block_starts[b])
        e = int(self.block_starts[b + 1]) if b + 1 < len(
            self.block_starts) else self.n
        self.fh.seek(self.data_off + s * self.rec_dt.itemsize)
        recs = np.frombuffer(
            self.fh.read((e - s) * self.rec_dt.itemsize), self.rec_dt)
        kv = _key_void(recs["kmer"].astype(np.uint64))
        i = int(np.searchsorted(kv, qv))
        if i >= len(kv) or kv[i] != qv:
            return None
        return (s + i, recs["covg"][i].astype(np.uint32),
                recs["edges"][i].astype(np.uint8))

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

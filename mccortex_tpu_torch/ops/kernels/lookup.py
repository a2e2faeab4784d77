"""Batched hash-bucket lookup: (Q, W) kmer keys -> (store row, found).

Counterpart of mccortex_tpu/ops/pallas/lookup.py (`build_table128`,
`lookup_fused`); kernels in csrc/lookup.cu (the probe, and the build of
the card's table).

Two table geometries, one layout.  A table is B = 2**b_bits rows of R
uint32; a row holds S = R // (2W+1) slots, plane-major
[w0_hi x S | w0_lo x S | ... | row_idx x S | pad], filled from the
front, empty and pad words 0xFFFFFFFF; a key's home row is
kmer_hash(key) >> (64 - b_bits).

  R = 32 (`build_table32`): the card's table.  A row is one 128-byte
      line of device memory, S = 10, 6, 4, 3 slots at W = 1..4, filled
      to about one half.  A row that is full sends its further keys to
      the next row (modulo B), so the table never has to grow to fit
      the fullest bucket.  `hashidx.lookup` uses this one; for CUDA keys
      it is built on the card (`build_table32_fused`, csrc/lookup.cu
      `mctx_table32`), byte for byte, numpy's build_table32 being its
      plain version.
  R = 128 (`build_table128`): the JAX package's table, byte for byte
      (a 128-lane vector of the TPU per bucket, filled to 0.35, grown
      until no bucket overflows).  Kept as the copy of the reference's
      layout; `chip_smoke.py` times it beside the other.

The plane-major order is kept for R = 32 too, rather than a slot-major
one: one kernel template and one plain version then serve both widths
with the same index arithmetic, and the kernel's compares run from
registers either way (a word's plane and slot follow from its position
in the row).

One probe serves both.  It starts at the home row and ends at a hit or
at the first row with an empty slot (its last slot is empty); a full
row without a hit sends it to the next row.  That is exact for
`build_table32`, which keeps the invariant that a key stored d rows
from home has d full rows before it, and for `build_table128`,
whose keys all sit in their home row.  A probe reads at most B rows, so
a table without any empty slot ends it too.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kmer as kops
from .. import sorted as sops
from . import _build

LANES = 128              # uint32 per row of the reference-shaped table
ROW32 = 32               # uint32 per row of the card's table: 128 bytes
ROW_WIDTHS = (ROW32, LANES)
OCC32 = 0.5              # target mean fill of the card's table
MAX_W = 4                # the kernel is instantiated for W = 1..4
_EMPTY = np.uint32(0xFFFFFFFF)


def slots_for(W: int, row_words: int = LANES) -> int:
    return row_words // (2 * W + 1)


def _write_slots(table, S, keys_np, rows, slots, store_rows):
    """Key words and store row of each key into (rows, slot) of the
    plane-major table."""
    for w in range(keys_np.shape[1]):
        kw = keys_np[store_rows, w]
        table[rows, (2 * w) * S + slots] = (kw >> np.uint64(32)).astype(
            np.uint32)
        table[rows, (2 * w + 1) * S + slots] = kw.astype(np.uint32)
    table[rows, 2 * keys_np.shape[1] * S + slots] = store_rows.astype(
        np.uint32)


def build_table128(keys_np: np.ndarray, occ: float = 0.35,
                   b_bits: int | None = None):
    """Build the 128-lane-row table from live (n, W) uint64 keys (host
    numpy, a copy of the JAX package's build_table128).

    Returns (table (B, 128) uint32, b_bits).  occ = target mean
    occupancy fraction of the S slots; grows b_bits until no bucket
    overflows."""
    n, W = keys_np.shape
    S = slots_for(W)
    if b_bits is None:
        target = max(1.0, n / max(S * occ, 1.0))
        b_bits = max(1, int(np.ceil(np.log2(target))))
    h = kops.kmer_hash_np(keys_np)
    while True:
        B = 1 << b_bits
        bucket = (h >> np.uint64(64 - b_bits)).astype(np.int64)
        occ_cnt = np.bincount(bucket, minlength=B)
        if occ_cnt.max() <= S:
            break
        b_bits += 1
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    start = np.searchsorted(sb, np.arange(B))
    rank = (np.arange(n) - start[sb]).astype(np.int64)
    table = np.full((B, LANES), _EMPTY, np.uint32)
    _write_slots(table, S, keys_np, sb, rank, order)
    return table, b_bits


def bits32(n: int, S: int, b_bits: int | None = None) -> int:
    """build_table32's b_bits for n keys at S slots a row: the smallest
    with a mean fill of at most OCC32 when none is given, then raised only
    as far as the keys need to fit (n <= B * S)."""
    if b_bits is None:
        b_bits = max(1, int(np.ceil(np.log2(max(1.0, n / (S * OCC32))))))
    while n > (S << b_bits):
        b_bits += 1
    return b_bits


def build_table32(keys_np: np.ndarray, b_bits: int | None = None):
    """Build the 128-byte-row table from live (n, W) uint64 keys (host
    numpy).  Returns (table (B, 32) uint32, b_bits).

    b_bits defaults to the smallest with a mean fill of at most OCC32 of
    the S slots; a given b_bits is raised only as far as the keys need
    to fit at all (n <= B * S).  Keys go to their home row in store
    order; the keys a row cannot take move to the next row (modulo B)
    and are placed there after that row's own, round after round until
    none is left.  A key only ever leaves a row that this round fills,
    so a key stored d rows from home has d full rows before it."""
    n, W = keys_np.shape
    S = slots_for(W, ROW32)
    b_bits = bits32(n, S, b_bits)
    B = 1 << b_bits
    table = np.full((B, ROW32), _EMPTY, np.uint32)
    fill = np.zeros(B, np.int64)
    # one word per key still to place: its row above its store row, so
    # that a plain sort orders the keys by row and, within a row, by
    # store row (much faster than a stable argsort of the rows)
    low = np.uint64(0xFFFFFFFF)
    home = kops.kmer_hash_np(keys_np) >> np.uint64(64 - b_bits)
    todo = (home << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    while len(todo):
        todo.sort()
        row = (todo >> np.uint64(32)).astype(np.int64)
        store = (todo & low).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        first = np.repeat(starts, np.diff(np.r_[starts, len(row)]))
        slot = fill[row] + np.arange(len(row)) - first
        fits = slot < S
        _write_slots(table, S, keys_np, row[fits], slot[fits], store[fits])
        fill += np.bincount(row[fits], minlength=B)
        todo = ((((row[~fits] + 1) & (B - 1)).astype(np.uint64)
                 << np.uint64(32)) | (todo[~fits] & low))
    return table, b_bits


def build_table32_fused(keys: torch.Tensor, b_bits: int | None = None):
    """build_table32 on the card: the table of the live keys (n, W) int64
    words on a CUDA device, the same bytes as build_table32's, built by
    csrc/lookup.cu (`mctx_table32`, then `mctx_table32_round` for each
    later round).  Returns (table (2**b_bits, 32) int32 on the keys'
    device, b_bits, rounds).  Only the number of keys left after each
    round, one word, comes back to the host.  The CPU builds with
    build_table32 (numpy), its plain version: a CPU tensor is refused."""
    if keys.dim() != 2 or keys.dtype != torch.int64 or \
            not 1 <= keys.shape[1] <= MAX_W:
        raise ValueError(f"keys must be (n, W) int64 words, 1 <= W <= "
                         f"{MAX_W}")
    if keys.device.type != "cuda":
        raise ValueError(f"build_table32_fused takes CUDA keys, got "
                         f"{keys.device}: build_table32 is the CPU build")
    with torch.cuda.device(keys.device):
        return _table32_launch(keys.contiguous(), b_bits)


def _table32_launch(keys: torch.Tensor, b_bits: int | None):
    """build_table32_fused's scratch and launches on the keys' device
    (scripts/cuda_emul runs it on CPU tensors, the kernels built for the
    CPU)."""
    n, W = keys.shape
    S = slots_for(W, ROW32)
    b_bits = bits32(n, S, b_bits)
    if n >= 1 << 31 or b_bits > 30:
        raise ValueError(f"the table kernel takes fewer than 2**31 keys and "
                         f"at most 2**30 rows, got {n} keys")
    B = 1 << b_bits
    dev = keys.device

    def words(m):
        return torch.empty(m, dtype=torch.int32, device=dev)

    table = torch.empty((B, ROW32), dtype=torch.int32, device=dev)
    # a row with more than S keys leaves one segment: at most n / (S + 1);
    # a round never leaves more segments than it was given
    segs, left = words(3 * (n // (S + 1) + 1)), words(1)
    # histogram, offsets, tile sums; home row, rank and bucket of each key
    scratch = [words(B), words(B), words(-(-B // 4096)), words(n), words(n)]
    bucket = words(n)
    first = _build.function("lookup", "mctx_table32", 10, 3)
    rc = first(keys.data_ptr(), table.data_ptr(),
               *[t.data_ptr() for t in scratch], bucket.data_ptr(),
               segs.data_ptr(), left.data_ptr(), n, W, b_bits,
               _build.stream_of(keys))
    _build.check(rc, "table")
    del scratch             # free for what this stream runs next
    rounds, m = 1, int(left)
    step = _build.function("lookup", "mctx_table32_round", 6, 3)
    out = words(3 * m)
    while m:
        rc = step(keys.data_ptr(), table.data_ptr(), bucket.data_ptr(),
                  segs.data_ptr(), out.data_ptr(), left.data_ptr(), m, W,
                  b_bits, _build.stream_of(keys))
        _build.check(rc, "table")
        rounds, m = rounds + 1, int(left)
        segs, out = out, segs
    return table, b_bits, rounds


def _probe_plain(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                 W: int):
    """(idx, found, rows read) per flat query: the chained probe in plain
    PyTorch, one gather of the pending queries' rows per chain step."""
    S = slots_for(W, table.shape[1])
    B = 1 << b_bits
    q = queries.reshape(-1, W)
    dev = q.device
    idx = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
    found = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
    rows = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
    # sentinel queries are never found and read no row (they would match
    # the empty slots)
    sel = (~sops.is_sentinel(q)).nonzero()[:, 0]
    bkt = kops.srl(kops.kmer_hash(q[sel]), 64 - b_bits)
    planes = [p[sel] for p in kops.query_planes(q)]
    for _ in range(B):
        if sel.numel() == 0:
            break
        row = table[bkt]                               # (pending, R)
        eq = torch.ones((sel.numel(), S), dtype=torch.bool, device=dev)
        for p, qp in enumerate(planes):
            eq &= row[:, p * S:(p + 1) * S] == qp[:, None]
        hit = eq.any(dim=-1)
        best = torch.where(eq, row[:, 2 * W * S:(2 * W + 1) * S], 0)
        idx[sel[hit]] = best.amax(dim=-1)[hit]
        found[sel[hit]] = True
        rows[sel] += 1
        # slots fill from the front, and an empty slot has all ones in its
        # top-word plane, which no live key has: the row is full iff its
        # last slot is taken
        go = ~hit & (row[:, S - 1] != -1)
        sel, bkt = sel[go], (bkt[go] + 1) & (B - 1)
        planes = [p[go] for p in planes]
    return idx, found, rows


def lookup_plain(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                 W: int):
    """Plain PyTorch version of the kernel (any device, either row
    width): the hash, the home rows, the section compares, and the next
    row for the queries whose row was full without a hit."""
    idx, found, _rows = _probe_plain(table, queries, b_bits, W)
    return (idx.reshape(queries.shape[:-1]),
            found.reshape(queries.shape[:-1]))


def rows_read(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
              W: int) -> torch.Tensor:
    """Table rows the probe reads for each query (0 for a sentinel)."""
    return _probe_plain(table, queries, b_bits, W)[2].reshape(
        queries.shape[:-1])


def lookup_fused(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                 W: int):
    """(idx int32, found bool) per query key (..., W) int64 against a
    (2**b_bits, 32) or (2**b_bits, 128) int32 table: idx is the store
    row when found, else 0; sentinel queries are never found.  Launches
    csrc/lookup.cu for CUDA tensors, the plain version for CPU
    tensors."""
    if not 1 <= b_bits <= 31 or table.dtype != torch.int32 or \
            table.dim() != 2 or table.shape[1] not in ROW_WIDTHS or \
            table.shape[0] != 1 << b_bits:
        raise ValueError(f"table must be (2**{b_bits}, {ROW32}) or "
                         f"(2**{b_bits}, {LANES}) int32")
    if queries.dtype != torch.int64 or queries.shape[-1] != W:
        raise ValueError(f"queries must be (..., {W}) int64 words")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"lookup kernel takes 1 <= W <= {MAX_W}, got {W}")
    if queries.device != table.device:
        raise ValueError(f"queries on {queries.device}, table on "
                         f"{table.device}")
    dev = queries.device
    if dev.type == "cpu":
        return lookup_plain(table, queries, b_bits, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    qshape = queries.shape[:-1]
    q = queries.reshape(-1, W).contiguous()
    Q = q.shape[0]
    if Q >= 1 << 31:
        raise ValueError(f"lookup takes fewer than 2**31 queries, got {Q}")
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q:
        fn = _build.function("lookup", "mctx_lookup", 4, 4)
        with torch.cuda.device(dev):
            rc = fn(q.data_ptr(), table.data_ptr(), idx.data_ptr(),
                    found.data_ptr(), Q, W, b_bits, table.shape[1],
                    _build.stream_of(q))
        _build.check(rc, "lookup")
    return idx.reshape(qshape), found.reshape(qshape)

"""Graph construction from reads: sort-and-reduce build epochs folded by
an LSM of merges.  Counterpart of mccortex_tpu/graph/build.py.

Per batch, one epoch turns the reads into unique (key, covg, edge)
records: the front-end kernel (k <= 63; the plain reads_to_records
above it), a sort of the key planes, and the segreduce kernel.  Epoch
outputs are folded into the store with binary-counter (LSM) merges;
every merge of two sorted items is a merge kernel plus the segreduce
kernel.  The same functions run on the CPU, where every kernel wrapper
takes its plain PyTorch version.

The sort engine is SORT_IMPL (environment MCTX_SORT, read at import;
set the module attribute to change it later):
  lax      torch.sort of the key planes; merges by the merge-path kernel
  lax64    the same (the port's torch.sort already pairs 32-bit planes
           into 64-bit words)
  mp       kernels only: tile sort + merge-path tree; merges by the
           merge-path kernel
  bitonic  kernels only: the bitonic network; merges by one bitonic
           merge stage over both sides padded to one power of two
Every engine gives the same graph.

Records travel as one (P, M) int32 tensor of planes: 2W key planes
(most significant first), then C coverage planes, then C edge planes.
A merge that does not fit on the device raises
torch.cuda.OutOfMemoryError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import nwords
from ..ops import kmer as kops
from ..ops import sorted as sops
from ..ops.kernels import bitonic, frontend, mergepath, segreduce
from ..utils.timing import count
from . import store as gstore

MIN_LEVEL = 1 << 15       # smallest LSM item capacity
SORT_IMPLS = ("lax", "lax64", "mp", "bitonic")


def _impl(sort_impl: str | None) -> str:
    """The engine asked for, or the module's; an unknown name raises."""
    impl = sort_impl or SORT_IMPL
    if impl not in SORT_IMPLS:
        raise ValueError(f"the sort engine (MCTX_SORT) must be one of "
                         f"{', '.join(SORT_IMPLS)}, got {impl!r}")
    return impl


SORT_IMPL = _impl(os.environ.get("MCTX_SORT", "lax"))


def _sort_planes32(planes: torch.Tensor, num_keys: int,
                   impl: str | None = None,
                   tile: int | None = None) -> torch.Tensor:
    """Sort (np, M) int32 planes on the first num_keys planes (unsigned,
    most significant first) with the engine `impl`.  The bitonic engine
    pads to a power of two of at least one tile (key pad -1 sorts last,
    value pad 0) and returns the padded length: callers slice; the
    sorted live prefix is unaffected.  `tile` is for the plain versions
    of the mp and bitonic engines."""
    impl = _impl(impl)
    if impl == "mp":
        return mergepath.sort_planes_mp(planes, num_keys, tile=tile)
    if impl == "bitonic":
        Mp = bitonic.padded_length(planes.shape[1], tile)
        return bitonic.sort_planes(bitonic.pad_planes(planes, num_keys, Mp),
                                   num_keys, tile=tile)
    return planes[:, sops.argsort_planes(planes[:num_keys])]


def mask_reads(bases: torch.Tensor, quals: torch.Tensor | None = None,
               fq_cutoff: int = 0, hp_cutoff: int = 0) -> torch.Tensor:
    """Quality/homopolymer masking: overwrite bases with the invalid code
    4, which breaks every kmer window covering them.

    quals: phred+0 integers, same shape as bases (or None); fq_cutoff:
    bases with qual < cutoff masked (0 = off); hp_cutoff: bases in
    homopolymer runs >= cutoff masked (0 = off).
    """
    if quals is not None and fq_cutoff > 0:
        bases = torch.where(quals < fq_cutoff, 4, bases).to(torch.uint8)
    if hp_cutoff > 0:
        # run[i] = number of consecutive same-as-previous bases ending at
        # i, by log2 doubling
        same_prev = torch.zeros_like(bases, dtype=torch.bool)
        same_prev[..., 1:] = (bases[..., 1:] == bases[..., :-1]) & \
            (bases[..., 1:] < 4)
        run = same_prev.to(torch.int32)
        d = 1
        while d < hp_cutoff:
            shifted = torch.zeros_like(run)
            shifted[..., d:] = run[..., :-d]
            run = torch.where(run == d, run + shifted, run)
            d *= 2
        bases = torch.where(run + 1 >= hp_cutoff, 4, bases).to(torch.uint8)
    return bases


def reads_to_records(bases: torch.Tensor, k: int):
    """(key, edge byte, valid) for every kmer window of a read batch.

    bases (B, L) uint8 codes (4 = invalid/pad).  Returns keys (B, L, W)
    int64 (sentinel where not valid), edge bytes (B, L) uint8 and valid
    (B, L) bool.  For the window at i with key orientation o, a following
    base b sets bit (b + 4*o) and a preceding base p sets bit
    (comp(p) + 4*(1-o)), each only when that neighbour window is valid.
    """
    B, L = bases.shape
    W = nwords(k)
    dev = bases.device
    if L < k:   # no window fits
        return (sops.sentinel((B, L), W, dev),
                torch.zeros((B, L), dtype=torch.uint8, device=dev),
                torch.zeros((B, L), dtype=torch.bool, device=dev))
    kmers, valid = kops.rolling_kmers(bases, k)
    keys, orient = kops.canonical(kmers, k)
    b = bases.to(torch.int64)
    nxt = torch.full_like(b, 4)
    nxt[:, :L - k] = b[:, k:]
    prv = torch.full_like(b, 4)
    prv[:, 1:] = b[:, :-1]
    valid_next = torch.zeros_like(valid)
    valid_next[:, :-1] = valid[:, 1:]
    valid_next &= valid
    valid_prev = torch.zeros_like(valid)
    valid_prev[:, 1:] = valid[:, :-1]
    valid_prev &= valid
    o = orient.to(torch.int64)
    fw_bit = 1 << ((nxt & 3) + (o << 2))
    rv_bit = 1 << (((3 - (prv & 3)) & 3) + ((1 - o) << 2))
    ebyte = torch.where(valid_next, fw_bit, 0) | \
        torch.where(valid_prev, rv_bit, 0)
    keys = torch.where(valid[..., None], keys, sops.SENTINEL)
    return keys, ebyte.to(torch.uint8), valid


def _epoch(bases: torch.Tensor, k: int, sort_impl: str | None = None,
           tile: int | None = None):
    """One build epoch on bases' device: reads -> unique records as
    planes (2W keys, count, edge) of M = B * (L-k+1) records, compacted
    and sentinel padded, plus the unique count (host int)."""
    B, L = bases.shape
    W = nwords(k)
    if W <= 2:
        # the kernel writes the first L-k+1 windows of every row, the
        # only ones that can hold a kmer
        planes = frontend.records_epoch(bases, k)
    else:
        Lv = frontend.epoch_windows(L, k)
        M = B * Lv
        keys, ebyte, _valid = reads_to_records(bases, k)
        planes = torch.cat([kops.to_planes(keys[:, :Lv].reshape(M, W)),
                            ebyte[:, :Lv].reshape(1, M).to(torch.int32)])
    M = planes.shape[1]
    planes = _sort_planes32(planes, 2 * W, sort_impl, tile)
    out, n = segreduce.segreduce_planes(planes[:2 * W], None,
                                        planes[2 * W:])
    return out[:, :M], int(n)


def count_batch(bases: torch.Tensor, k: int, ncols: int, colour: int,
                sort_impl: str | None = None, tile: int | None = None):
    """One build epoch: reads -> aggregated unique (keys, covg, edges).

    Returns (keys (M, W) int64, covg (M, ncols) int32, edges (M, ncols)
    uint8, n_unique) with M = B*(L-k+1), compacted, sentinel padded,
    sorted; on bases' device (kernels on CUDA, plain versions on CPU).
    """
    planes, n = _epoch(bases, k, sort_impl, tile)
    W = nwords(k)
    M = planes.shape[1]
    covg = torch.zeros((M, ncols), dtype=torch.int32, device=planes.device)
    covg[:, colour] = planes[2 * W]
    edges = torch.zeros((M, ncols), dtype=torch.uint8, device=planes.device)
    edges[:, colour] = planes[2 * W + 1].to(torch.uint8)
    return kops.from_planes(planes[:2 * W]), covg, edges, n


def _capacity(n: int, size: int) -> int:
    """LSM item capacity for n live records of a size-record array: the
    next power of two >= n (at least MIN_LEVEL, at most size), so merges
    scale with unique kmers."""
    cap = MIN_LEVEL
    while cap < n:
        cap *= 2
    return min(cap, size)


def _record_planes(keys: torch.Tensor, covg: torch.Tensor,
                   edges: torch.Tensor) -> torch.Tensor:
    """keys (M, W) int64 + covg (M, C) int32 + edges (M, C) uint8 -> one
    (2W + 2C, M) int32 tensor of planes: key planes most significant
    first, then coverage, then edges."""
    return torch.cat([kops.to_planes(keys), covg.T.to(torch.int32),
                      edges.T.to(torch.int32)])


def _aggregate_planes(sorted_planes: torch.Tensor, W: int, C: int):
    """The segreduce kernel over sorted record planes (coverage planes
    summed modulo 2**32, edge planes OR-ed).  Returns (planes, n): the
    unique records compacted to the front, and their number (host int)."""
    planes, n = segreduce.segreduce_planes(
        sorted_planes[:2 * W], sorted_planes[2 * W:2 * W + C],
        sorted_planes[2 * W + C:], count=False)
    return planes, int(n)


def _aggregate_sorted(sorted_planes: torch.Tensor, W: int, C: int,
                      M_out: int):
    """Shared tail of reduce_records_fused and merge_sorted_fused:
    segreduce over sorted planes, reassembled to (M_out, W) keys,
    (M_out, C) covg and edges, and the live count (host int)."""
    planes, n = _aggregate_planes(sorted_planes, W, C)
    planes = planes[:, :M_out]
    return (kops.from_planes(planes[:2 * W]),
            planes[2 * W:2 * W + C].T.contiguous(),
            planes[2 * W + C:].T.to(torch.uint8).contiguous(), n)


def reduce_records_fused(keys: torch.Tensor, covg: torch.Tensor,
                         edges: torch.Tensor, sort_impl: str | None = None,
                         tile: int | None = None):
    """Sort + aggregate one unaggregated record array: keys (M, W) int64,
    covg (M, C) int32, edges (M, C) uint8 -> the same shapes with the
    sorted unique records at the front (sentinel keys and zeros after),
    plus the live count.  The one path by which a store is (re)built
    from records (store.from_records)."""
    M, W = keys.shape
    C = covg.shape[1]
    planes = _sort_planes32(_record_planes(keys, covg, edges), 2 * W,
                            sort_impl, tile)
    return _aggregate_sorted(planes, W, C, M)


def _merge(a: torch.Tensor, b: torch.Tensor, W: int, C: int,
           sort_impl: str | None = None, tile: int | None = None):
    """Merge two sorted items (record planes), then segreduce.  The lax
    and mp engines merge with the merge-path kernel in one data pass at
    the items' own lengths; the bitonic engine pads both sides to one
    power of two and runs one bitonic merge stage.  Returns (planes of
    a.shape[1] + b.shape[1] records, n)."""
    M_out = a.shape[1] + b.shape[1]
    if _impl(sort_impl) == "bitonic":
        Mp = bitonic.padded_length(max(a.shape[1], b.shape[1]), tile)
        merged = bitonic.merge_planes(bitonic.pad_planes(a, 2 * W, Mp),
                                      bitonic.pad_planes(b, 2 * W, Mp),
                                      2 * W, tile=tile)
    else:
        merged = mergepath.merge_path_planes(a, b, num_keys=2 * W)
    planes, n = _aggregate_planes(merged, W, C)
    return planes[:, :M_out], n


def merge_sorted_fused(ak, ac, ae, bk, bc, be, sort_impl: str | None = None,
                       tile: int | None = None):
    """Merge two sorted sentinel-padded record arrays (keys (M, W) int64,
    covg (M, C) int32, edges (M, C) uint8 each) into one of Ma + Mb
    records: covg summed per colour, edges OR-ed, unique records at the
    front.  Returns (keys, covg, edges, n)."""
    W, C = ak.shape[1], ac.shape[1]
    planes, n = _merge(_record_planes(ak, ac, ae), _record_planes(bk, bc, be),
                       W, C, sort_impl, tile)
    return (kops.from_planes(planes[:2 * W]),
            planes[2 * W:2 * W + C].T.contiguous(),
            planes[2 * W + C:].T.to(torch.uint8).contiguous(), n)


class RecordFold:
    """Binary-counter LSM of sorted record items on one device: an item's
    level is the sum of the capacities merged into it, and two items of
    one level are merged (and compacted) until the levels on the stack
    all differ.  `build` folds its epochs with it; parallel/shard.py
    folds what each shard receives.  The counter `fold.bytes` adds the
    bytes of the records each merge takes in and gives out (8W + 5C a
    record: the .ctx record's size)."""

    def __init__(self, W: int, C: int):
        self.W, self.C = W, C
        self._stack = []   # [(level, planes, n live)], levels decreasing

    def _merge(self, a: torch.Tensor, b: torch.Tensor):
        planes, n = _merge(a, b, self.W, self.C)
        count("fold.bytes", (a.shape[1] + b.shape[1] + n)
              * (8 * self.W + 5 * self.C))
        return planes, n

    def push(self, item: torch.Tensor, n: int) -> None:
        """Fold one item: (2W + 2C, m) record planes, its n unique
        records sorted at the front and sentinels after.  It is cut to
        _capacity(n, m) records."""
        item = item[:, :_capacity(n, item.shape[1])]
        level = item.shape[1]
        while self._stack and self._stack[-1][0] == level:
            other_level, other, _ = self._stack.pop()
            merged, n = self._merge(other, item)
            item = merged[:, :_capacity(n, merged.shape[1])].contiguous()
            level += other_level
        self._stack.append((level, item, n))

    def result(self):
        """(planes, n) of everything pushed, merged into one sorted item,
        or None when nothing was pushed."""
        if not self._stack:
            return None
        _, item, n = self._stack.pop()
        while self._stack:
            _, other, _ = self._stack.pop()
            item, n = self._merge(other, item)
        return item, n


def colour_item(planes: torch.Tensor, n: int, W: int, C: int,
                colour: int) -> torch.Tensor:
    """An epoch's output (planes of 2W keys, count and edge byte; n
    unique records) as record planes of C colours, the count and edges
    in `colour`, cut to _capacity(n, M) records."""
    cap = _capacity(n, planes.shape[1])
    item = torch.zeros((2 * W + 2 * C, cap), dtype=torch.int32,
                       device=planes.device)
    item[:2 * W] = planes[:2 * W, :cap]
    item[2 * W + colour] = planes[2 * W, :cap]
    item[2 * W + C + colour] = planes[2 * W + 1, :cap]
    return item


def store_of_planes(planes: torch.Tensor, n: int, k: int,
                    capacity: int | None = None) -> gstore.DBGraph:
    """A store from sorted unique record planes (n live records first),
    padded with sentinels to `capacity` when that is larger than n."""
    W = nwords(k)
    C = (planes.shape[0] - 2 * W) // 2
    g = gstore.DBGraph(
        keys=kops.from_planes(planes[:2 * W, :n]),
        covg=planes[2 * W:2 * W + C, :n].T.contiguous(),
        edges=planes[2 * W + C:, :n].T.to(torch.uint8).contiguous(),
        n=n, k=k)
    if capacity and capacity > n:
        pad = gstore.empty(k, capacity - n, C, planes.device)
        g = gstore.DBGraph(keys=torch.cat([g.keys, pad.keys]),
                           covg=torch.cat([g.covg, pad.covg]),
                           edges=torch.cat([g.edges, pad.edges]), n=n, k=k)
    return g


def build(reads_batches, k: int, ncols: int = 1,
          device: str | torch.device = "cuda",
          capacity: int | None = None) -> gstore.DBGraph:
    """Build a graph from an iterable of (bases (B, L) uint8, colour).

    Each batch is copied to `device` and aggregated there by one epoch,
    then folded into a binary-counter LSM (RecordFold).  `capacity` is a
    hint of the store's size in kmers: the store is padded to it when it
    holds fewer and grows past it when it holds more.
    """
    device = torch.device(device)
    W = nwords(k)
    fold = RecordFold(W, ncols)
    for bases, colour in reads_batches:
        bt = torch.as_tensor(bases, dtype=torch.uint8).to(device)
        planes, n = _epoch(bt, k)
        fold.push(colour_item(planes, n, W, ncols, colour), n)
    res = fold.result()
    if res is None:
        return gstore.empty(k, capacity or 0, ncols, device)
    return store_of_planes(*res, k, capacity)


class PcrDupFilter:
    """PCR duplicate removal: a read (or pair) is dropped iff all its
    start kmers were seen before as read starts in the same orientation.

    The start kmers of a whole batch are computed on `device`; the
    (key, orientation) tokens are matched on the host against an LSM of
    sorted token runs with numpy searchsorted, and the sequential rule
    ("seen by an earlier read of this stream") becomes a minimum read
    index per token, which equals a sequential loop: a dropped read's
    tokens were already seen, so marking every read's tokens equals
    marking the kept reads' only.  All state lives in the instance.
    """

    def __init__(self, k: int, device: str | torch.device = "cuda"):
        self.k = k
        self.W = nwords(k)
        self.device = torch.device(device)
        self._runs = []   # LSM: sorted void-token arrays

    def _tokens(self, keys: np.ndarray, orient: np.ndarray) -> np.ndarray:
        comb = np.concatenate(
            [keys, orient[:, None].astype(np.uint64)], axis=1)
        return np.ascontiguousarray(comb).view(
            np.dtype((np.void, 8 * (self.W + 1)))).ravel()

    def _in_store(self, toks: np.ndarray) -> np.ndarray:
        out = np.zeros(len(toks), bool)
        for run in self._runs:
            if len(run) == 0 or len(toks) == 0:
                continue
            i = np.minimum(np.searchsorted(run, toks), len(run) - 1)
            out |= run[i] == toks
        return out

    def _add(self, toks: np.ndarray):
        if len(toks) == 0:
            return
        self._runs.append(np.unique(toks))
        while len(self._runs) >= 2 and \
                len(self._runs[-1]) >= len(self._runs[-2]):
            b = self._runs.pop()
            a = self._runs.pop()
            self._runs.append(np.unique(np.concatenate([a, b])))

    def _start_info(self, bases: np.ndarray):
        """(keys (N, W) uint64, orient (N,), valid (N,)) of each read's
        first kmer; reads shorter than k or with an invalid base among
        their first k are not valid."""
        N, L = bases.shape
        if L < self.k:
            return (np.zeros((N, self.W), np.uint64), np.zeros(N, np.int64),
                    np.zeros(N, bool))
        head = torch.from_numpy(np.ascontiguousarray(bases[:, :self.k])
                                ).to(self.device)
        kmers, valid = kops.rolling_kmers(head, self.k)
        keys, orient = kops.canonical(kmers[:, 0], self.k)
        return (keys.cpu().numpy().view(np.uint64), orient.cpu().numpy(),
                valid[:, 0].cpu().numpy())

    def filter_batch(self, bases: np.ndarray,
                     bases2: np.ndarray | None = None) -> np.ndarray:
        """Keep mask of one batch.  For pairs, a pair is dropped only if
        both mates' start kmers were seen."""
        N = len(bases)
        k1, o1, v1 = self._start_info(bases)
        sides = [(self._tokens(k1, o1), v1)]
        if bases2 is not None:
            k2, o2, v2 = self._start_info(bases2)
            sides.append((self._tokens(k2, o2), v2))

        # min read index per token within this batch ("seen by an
        # earlier read in the stream")
        pool = np.concatenate([t[v] for t, v in sides])
        ridx = np.concatenate(
            [np.nonzero(v)[0] for _t, v in sides]).astype(np.int64)
        if len(pool):
            order = np.lexsort((ridx, pool))
            sp, sr = pool[order], ridx[order]
            first = np.ones(len(sp), bool)
            first[1:] = sp[1:] != sp[:-1]
            utok = sp[first]
            umin = sr[first]      # min read idx: lexsort is stable
        else:
            utok = pool
            umin = ridx

        def seen_of(t, v):
            seen = np.zeros(N, bool)
            if v.any():
                tv = t[v]
                s = self._in_store(tv)
                i = np.minimum(np.searchsorted(utok, tv),
                               max(len(utok) - 1, 0))
                if len(utok):
                    s |= (utok[i] == tv) & \
                        (umin[i] < np.nonzero(v)[0])
                seen[v] = s
            return seen

        seen1 = seen_of(*sides[0])
        if bases2 is None:
            all_seen = seen1 & v1
        else:
            seen2 = seen_of(*sides[1])
            v2 = sides[1][1]
            any_token = v1 | v2
            # AND over present tokens only (absent mate is neutral)
            all_seen = any_token & \
                np.where(v1, seen1, True) & np.where(v2, seen2, True)
        self._add(pool)
        return ~all_seen

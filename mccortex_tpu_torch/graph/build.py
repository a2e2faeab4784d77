"""Graph construction from reads: sort-and-reduce build epochs folded by
an LSM of merges.  Counterpart of mccortex_tpu/graph/build.py.

Per batch, one epoch turns the reads into unique (key, covg, edge)
records: the front-end kernel (k <= 63; the plain reads_to_records
above it), a torch.sort of the key planes, and the segreduce kernel.
Epoch outputs are folded into the store with binary-counter (LSM)
merges; every merge of two sorted items is the merge-path kernel plus
the segreduce kernel.  The same functions run on the CPU, where every
kernel wrapper takes its plain PyTorch version.

Records travel as one (P, M) int32 tensor of planes: 2W key planes
(most significant first), then C coverage planes, then C edge planes.
A merge that does not fit on the device raises
torch.cuda.OutOfMemoryError.
"""

from __future__ import annotations

import torch

from ..constants import nwords
from ..ops import kmer as kops
from ..ops import sorted as sops
from ..ops.kernels import frontend, mergepath, segreduce
from . import store as gstore

MIN_LEVEL = 1 << 15       # smallest LSM item capacity


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


def _epoch(bases: torch.Tensor, k: int):
    """One build epoch on bases' device: reads -> unique records as
    planes (2W keys, count, edge) of M = B * (L-k+1) records, compacted
    and sentinel padded, plus the unique count (host int)."""
    B, L = bases.shape
    W = nwords(k)
    # only the first L-k+1 positions can hold a valid window
    Lv = max(L - k + 1, 1)
    M = B * Lv
    if W <= 2:
        planes = torch.stack(frontend.records_fused(bases, k))
        planes = planes[:, :, :Lv].reshape(2 * W + 1, M)
    else:
        keys, ebyte, _valid = reads_to_records(bases, k)
        planes = torch.cat([kops.to_planes(keys[:, :Lv].reshape(M, W)),
                            ebyte[:, :Lv].reshape(1, M).to(torch.int32)])
    planes = planes[:, sops.argsort_planes(planes[:2 * W])]
    okeys, count, _sums, oors, n = segreduce.segreduce_compact_multi(
        planes[:2 * W], None, planes[2 * W:])
    return torch.cat([okeys, count[None], oors]), int(n)


def count_batch(bases: torch.Tensor, k: int, ncols: int, colour: int):
    """One build epoch: reads -> aggregated unique (keys, covg, edges).

    Returns (keys (M, W) int64, covg (M, ncols) int32, edges (M, ncols)
    uint8, n_unique) with M = B*(L-k+1), compacted, sentinel padded,
    sorted; on bases' device (kernels on CUDA, plain versions on CPU).
    """
    planes, n = _epoch(bases, k)
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


def _merge(a: torch.Tensor, b: torch.Tensor, W: int, C: int):
    """Merge two sorted items: merge path, then segreduce (covg planes
    summed, edge planes OR-ed).  Returns (planes, n)."""
    merged = mergepath.merge_path_planes(a, b, num_keys=2 * W)
    okeys, _count, osums, oors, n = segreduce.segreduce_compact_multi(
        merged[:2 * W], merged[2 * W:2 * W + C], merged[2 * W + C:])
    return torch.cat([okeys, osums, oors]), int(n)


def build(reads_batches, k: int, ncols: int = 1,
          device: str | torch.device = "cuda") -> gstore.DBGraph:
    """Build a graph from an iterable of (bases (B, L) uint8, colour).

    Each batch is copied to `device` and aggregated there by one epoch,
    then folded into a binary-counter LSM: an item's level is the sum of
    the epoch capacities merged into it, and two items of one level are
    merged (and compacted) until the levels on the stack all differ.
    """
    device = torch.device(device)
    W = nwords(k)
    C = ncols
    stack = []   # [(level, planes, n live)], levels strictly decreasing

    for bases, colour in reads_batches:
        bt = torch.as_tensor(bases, dtype=torch.uint8).to(device)
        planes, n = _epoch(bt, k)
        cap = _capacity(n, planes.shape[1])
        item = torch.zeros((2 * W + 2 * C, cap), dtype=torch.int32,
                           device=device)
        item[:2 * W] = planes[:2 * W, :cap]
        item[2 * W + colour] = planes[2 * W, :cap]
        item[2 * W + C + colour] = planes[2 * W + 1, :cap]
        level = cap
        while stack and stack[-1][0] == level:
            other_level, other, _ = stack.pop()
            merged, n = _merge(other, item, W, C)
            item = merged[:, :_capacity(n, merged.shape[1])].contiguous()
            level += other_level
        stack.append((level, item, n))

    if not stack:
        return gstore.empty(k, 0, ncols, device)
    _, item, n = stack.pop()
    while stack:
        _, other, _ = stack.pop()
        item, n = _merge(other, item, W, C)
    return gstore.DBGraph(
        keys=kops.from_planes(item[:2 * W, :n]),
        covg=item[2 * W:2 * W + C, :n].T.contiguous(),
        edges=item[2 * W + C:, :n].T.to(torch.uint8).contiguous(),
        n=n, k=k)

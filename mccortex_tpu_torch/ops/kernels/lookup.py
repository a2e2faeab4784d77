"""Batched hash-bucket lookup against the 128-lane table.

Counterpart of mccortex_tpu/ops/pallas/lookup.py (`build_table128`,
`lookup_fused`); kernel in csrc/lookup.cu.  The table is one 512-byte
row of 128 uint32 per bucket: S = 128 // (2W+1) slots of each plane
[w0_hi | w0_lo | ... | row_idx | pad], empty slots 0xFFFFFFFF.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kmer as kops
from .. import sorted as sops
from ..hashidx import _hash_np, query_planes
from . import _build

LANES = 128
MAX_W = 4                # the kernel is instantiated for W = 1..4
_EMPTY = np.uint32(0xFFFFFFFF)


def slots_for(W: int) -> int:
    return LANES // (2 * W + 1)


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
    h = _hash_np(keys_np)
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
    for w in range(W):
        kw = keys_np[order, w]
        table[sb, (2 * w) * S + rank] = (kw >> np.uint64(32)).astype(
            np.uint32)
        table[sb, (2 * w + 1) * S + rank] = kw.astype(np.uint32)
    table[sb, 2 * W * S + rank] = order.astype(np.uint32)
    return table, b_bits


def lookup_plain(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                 W: int):
    """Plain PyTorch version of the kernel (any device): the hash, one
    gather of the (Q, 128) bucket rows, the section compares."""
    S = slots_for(W)
    q = queries.reshape(-1, W)
    bkt = kops.srl(kops.kmer_hash(q), 64 - b_bits)
    row = table[bkt]                                   # (Q, 128)
    eq = torch.ones((q.shape[0], S), dtype=torch.bool, device=q.device)
    for p, qp in enumerate(query_planes(q)):
        eq &= row[:, p * S:(p + 1) * S] == qp[:, None]
    # found is masked by valid before idx is zeroed: a sentinel query
    # matches the empty slots
    found = eq.any(dim=-1) & ~sops.is_sentinel(q)
    best = torch.where(eq, row[:, 2 * W * S:(2 * W + 1) * S], 0)
    idx = torch.where(found, best.amax(dim=-1), 0)
    return (idx.reshape(queries.shape[:-1]),
            found.reshape(queries.shape[:-1]))


def lookup_fused(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                 W: int):
    """(idx int32, found bool) per query key (..., W) int64 against the
    (2**b_bits, 128) int32 table: idx is the store row when found, else
    0; sentinel queries are never found.  Launches csrc/lookup.cu for
    CUDA tensors, the plain version for CPU tensors."""
    if not 1 <= b_bits <= 31 or table.dtype != torch.int32 or \
            table.dim() != 2 or table.shape[1] != LANES or \
            table.shape[0] != 1 << b_bits:
        raise ValueError(f"table must be (2**{b_bits}, {LANES}) int32")
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
        fn = _build.function("lookup", "mctx_lookup", 4, 3)
        with torch.cuda.device(dev):
            rc = fn(q.data_ptr(), table.data_ptr(), idx.data_ptr(),
                    found.data_ptr(), Q, W, b_bits, _build.stream_of(q))
        _build.check(rc, "lookup")
    return idx.reshape(qshape), found.reshape(qshape)

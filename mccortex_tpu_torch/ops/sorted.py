"""Sorted-array primitives (plain PyTorch); counterpart of
mccortex_tpu/ops/sorted.py.

The graph's kmer set lives as a sorted key array; duplicate records are
combined with segmented reductions.  Padding slots hold the sentinel
(all ones: -1 in every int64 word or int32 plane), which is never a
valid kmer and sorts after every real key in unsigned order.
"""

from __future__ import annotations

import torch

from .kmer import SIGN, mw_eq, mw_lt

SENTINEL = -1


def sentinel(shape_prefix, W: int, device=None) -> torch.Tensor:
    return torch.full(tuple(shape_prefix) + (W,), SENTINEL,
                      dtype=torch.int64, device=device)


def is_sentinel(keys: torch.Tensor) -> torch.Tensor:
    """True where a key row is padding (all ones)."""
    return (keys == SENTINEL).all(dim=-1)


def _lsd_perm(words, n: int, device) -> torch.Tensor:
    """Stable permutation sorting by the int64 words (most significant
    first, signed order): LSD passes of stable sorts."""
    perm = torch.arange(n, device=device)
    for w in reversed(words):
        idx = torch.sort(w[perm], stable=True).indices
        perm = perm[idx]
    return perm


def argsort_planes(planes: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting (NK, M) int32 planes in unsigned
    lexicographic order, plane 0 most significant.  Planes are paired
    into sign-flipped int64 words, so W=1 keys take one sort."""
    p = planes.to(torch.int64) & 0xFFFFFFFF
    nk = p.shape[0]
    words = [((p[i] << 32) | p[i + 1]) ^ SIGN for i in range(0, nk - 1, 2)]
    if nk % 2:
        words.append(p[nk - 1])          # < 2**32: signed order is fine
    return _lsd_perm(words, planes.shape[1], planes.device)


def sort_by_key(keys: torch.Tensor, *vals):
    """Sort records by multiword key (stable); returns (keys_sorted,
    *vals_sorted).  keys (N, W) int64; vals have leading dim N."""
    words = [keys[:, w] ^ SIGN for w in range(keys.shape[1])]
    perm = _lsd_perm(words, keys.shape[0], keys.device)
    return (keys[perm],) + tuple(v[perm] for v in vals)


def searchsorted_mw(sorted_keys: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """First index i with sorted_keys[i] >= query (side "left"), as int32
    of shape queries.shape[:-1].  sorted_keys (M, W) int64 ascending in
    unsigned order (a sentinel tail is fine); queries (..., W)."""
    return _searchsorted(sorted_keys, queries, "left")


def _searchsorted(sorted_keys, queries, side: str) -> torch.Tensor:
    M, W = sorted_keys.shape
    if W == 1:
        return torch.searchsorted(
            sorted_keys[:, 0] ^ SIGN, (queries[..., 0] ^ SIGN).contiguous(),
            right=side == "right").to(torch.int32)
    qshape = queries.shape[:-1]
    lo = torch.zeros(qshape, dtype=torch.int64, device=queries.device)
    hi = torch.full(qshape, M, dtype=torch.int64, device=queries.device)
    for _ in range(max(1, max(M, 2).bit_length() + 1)):
        mid = (lo + hi) >> 1
        kmid = sorted_keys[mid.clamp(0, max(M - 1, 0))]
        if side == "left":
            ahead = mw_lt(kmid, queries)      # kmid < q
        else:
            ahead = ~mw_lt(queries, kmid)     # kmid <= q
        ahead &= lo < hi
        lo = torch.where(ahead, mid + 1, lo)
        hi = torch.where(ahead, hi, torch.minimum(mid, hi))
    return lo.to(torch.int32)


def searchsorted_chunked(sorted_keys: torch.Tensor, queries: torch.Tensor,
                         side: str = "left") -> torch.Tensor:
    """searchsorted_mw with side "left" or "right", in one call whatever
    the number of queries (the name is the JAX package's, which cuts the
    queries into pieces for its device)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be left or right, got {side!r}")
    return _searchsorted(sorted_keys, queries, side)


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """(idx, found) per query key by binary search: idx is the key's row
    when found, else the insertion point clipped to the last row.
    Sentinel queries are never found."""
    M = sorted_keys.shape[0]
    idx = searchsorted_mw(sorted_keys, queries).clamp(0, max(M - 1, 0))
    found = mw_eq(sorted_keys[idx.long()], queries) & ~is_sentinel(queries)
    return idx, found


def segmented_or(vals: torch.Tensor, seg: torch.Tensor,
                 num_out: int) -> torch.Tensor:
    """Bitwise OR of vals (N, C) over ascending segment ids seg (N,):
    a doubling inclusive scan within segments, read at segment ends."""
    N = vals.shape[0]
    v = vals.clone()
    d = 1
    while d < N:
        same = (seg[d:] == seg[:-d])[:, None]
        v[d:] = v[d:] | torch.where(same, v[:-d], torch.zeros_like(v[:-d]))
        d *= 2
    out = torch.zeros((num_out,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    if N:
        end = torch.ones(N, dtype=torch.bool, device=vals.device)
        end[:-1] = seg[1:] != seg[:-1]
        end &= seg < num_out
        out[seg[end]] = v[end]
    return out


def unique_reduce(sorted_keys: torch.Tensor, covg: torch.Tensor,
                  edges: torch.Tensor, num_out: int):
    """Combine duplicate adjacent keys: covg summed (wrapping in its
    dtype), edges OR-ed.

    sorted_keys (N, K) integer rows ascending with sentinel rows last;
    covg (N, C); edges (N, C').  Returns (keys (num_out, K), covg
    (num_out, C), edges (num_out, C'), n_unique 0-d int64 tensor),
    compacted to the front, sentinel/zero padded.
    """
    N = sorted_keys.shape[0]
    dev = sorted_keys.device
    valid = ~is_sentinel(sorted_keys)
    is_start = torch.ones(N, dtype=torch.bool, device=dev)
    is_start[1:] = (sorted_keys[1:] != sorted_keys[:-1]).any(dim=-1)
    seg = torch.cumsum(is_start, 0) - 1
    in_range = seg < num_out
    take = valid & in_range
    covg_out = torch.zeros((num_out, covg.shape[1]), dtype=torch.int64,
                           device=dev)
    covg_out.index_add_(0, seg[take], covg[take].to(torch.int64))
    edges_out = segmented_or(edges * valid[:, None].to(edges.dtype), seg,
                             num_out)
    keys_out = torch.full((num_out, sorted_keys.shape[1]), SENTINEL,
                          dtype=sorted_keys.dtype, device=dev)
    first = is_start & take
    keys_out[seg[first]] = sorted_keys[first]
    return (keys_out, covg_out.to(covg.dtype), edges_out,
            (is_start & valid).sum())

"""Sorted-array primitives (plain PyTorch); counterpart of
mccortex_tpu/ops/sorted.py.

The graph's kmer set lives as a sorted key array; duplicate records are
combined with segmented reductions.  Padding slots hold the sentinel
(all ones: -1 in every int64 word or int32 plane), which is never a
valid kmer and sorts after every real key in unsigned order.
"""

from __future__ import annotations

import torch

from .kmer import SIGN

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


def lookup_join(sorted_keys: torch.Tensor, queries: torch.Tensor,
                variant: str = "lax"):
    """Bulk exact lookup by sort-merge join: (idx int32, found bool) per
    query (..., W), idx the store row when found else 0.

    One stable sort of the store+query key words; a query is found iff
    its run of equal keys holds a store row (store keys are unique, so
    at most one): the run's max of (is_store ? pos : -1), which is what
    the JAX package's forward and backward segmented max scans give;
    then the queries are put back in their order by a scatter.
    sorted_keys (N, W) ascending with sentinel padding; sentinel queries
    are never found.
    """
    if variant == "mp":
        raise NotImplementedError(
            "lookup_join(variant='mp') is not yet ported (ROADMAP Queue 2): "
            "it needs the sort_planes_mp kernel")
    if variant != "lax":
        raise ValueError(f"unknown lookup_join variant {variant!r}")
    N, W = sorted_keys.shape
    q = queries.reshape(-1, W)
    Q = q.shape[0]
    dev = q.device
    allk = torch.cat([sorted_keys, q])
    perm = _lsd_perm([allk[:, w] ^ SIGN for w in range(W)], N + Q, dev)
    mk = allk[perm]
    is_store = perm < N
    bound = torch.ones(N + Q, dtype=torch.bool, device=dev)
    bound[1:] = (mk[1:] != mk[:-1]).any(dim=-1)
    run = torch.cumsum(bound, 0) - 1
    val = torch.where(is_store, perm, -1)
    best = torch.full((N + Q,), -1, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, run, val, "amax")[run]
    found = (best >= 0) & ~is_store & ~is_sentinel(mk)
    qpos = perm[~is_store] - N
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    fnd = torch.empty(Q, dtype=torch.bool, device=dev)
    idx[qpos] = torch.where(found, best, 0)[~is_store].to(torch.int32)
    fnd[qpos] = found[~is_store]
    return (idx.reshape(queries.shape[:-1]),
            fnd.reshape(queries.shape[:-1]))


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

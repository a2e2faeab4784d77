"""The coloured de Bruijn graph store; counterpart of
mccortex_tpu/graph/store.py.

A sorted (cap, W) int64 key array (uint64 bit views, ascending in
unsigned order, sentinel padded) with parallel (cap, C) coverage and
edge arrays, on one device.  The live records are the first n rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import check_k, nwords
from ..ops import sorted as sops


@dataclasses.dataclass
class DBGraph:
    """Sorted coloured kmer store."""
    keys: torch.Tensor    # (cap, W) int64, ascending unsigned, sentinel padded
    covg: torch.Tensor    # (cap, C) int32 (uint32 bit views)
    edges: torch.Tensor   # (cap, C) uint8
    n: int                # live kmers
    k: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def ncols(self) -> int:
        return self.covg.shape[1]

    @property
    def W(self) -> int:
        return self.keys.shape[1]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def empty(k: int, capacity: int, ncols: int, device=None) -> DBGraph:
    check_k(k)
    return DBGraph(
        keys=sops.sentinel((capacity,), nwords(k), device),
        covg=torch.zeros((capacity, ncols), dtype=torch.int32, device=device),
        edges=torch.zeros((capacity, ncols), dtype=torch.uint8,
                          device=device),
        n=0, k=k)


def to_host(g: DBGraph):
    """Live records as numpy (keys (n, W) uint64, covg (n, C) uint32,
    edges (n, C) uint8), as mccortex_tpu.graph.store.to_host gives."""
    n = g.n
    return (g.keys[:n].cpu().numpy().view(np.uint64),
            g.covg[:n].cpu().numpy().view(np.uint32),
            g.edges[:n].cpu().numpy())


def from_host(keys_u64: np.ndarray, covg: np.ndarray, edges: np.ndarray,
              k: int, device=None) -> DBGraph:
    """Store from host records that are already sorted and unique, e.g.
    mccortex_tpu.graph.store.to_host or io.ctx.read_ctx output: the
    state carried across from the JAX package."""
    check_k(k)
    keys = np.require(keys_u64, np.uint64, ["C", "W"])
    if keys.ndim != 2 or keys.shape[1] != nwords(k):
        raise ValueError(f"keys must be (n, {nwords(k)}) uint64 for k={k}")
    covg = np.require(covg, np.uint32, ["C", "W"])
    edges = np.require(edges, np.uint8, ["C", "W"])
    if covg.shape != edges.shape or covg.shape[0] != keys.shape[0]:
        raise ValueError("covg and edges must be (n, C) for n keys")
    return DBGraph(keys=torch.from_numpy(keys.view(np.int64)).to(device),
                   covg=torch.from_numpy(covg.view(np.int32)).to(device),
                   edges=torch.from_numpy(edges).to(device),
                   n=keys.shape[0], k=k)


def from_records(k: int, keys: torch.Tensor, covg: torch.Tensor,
                 edges: torch.Tensor, capacity: int | None = None) -> DBGraph:
    """Store from unaggregated (key, covg, edges) records: keys (N, W)
    int64, covg (N, C) int32, edges (N, C) uint8, on one device.  Records
    with sentinel keys are ignored; capacity defaults to N.  Sorted and
    aggregated by build.reduce_records_fused under the build's sort
    engine (covg summed modulo 2**32, edges OR-ed)."""
    from . import build as gbuild
    check_k(k)
    N = keys.shape[0]
    C = covg.shape[1]
    capacity = capacity or N
    if N == 0:
        return empty(k, capacity, C, keys.device)
    okeys, ocovg, oedges, n = gbuild.reduce_records_fused(
        keys, covg.to(torch.int32), edges)
    g = empty(k, capacity, C, keys.device)
    m = min(N, capacity)
    g.keys[:m] = okeys[:m]
    g.covg[:m] = ocovg[:m]
    g.edges[:m] = oedges[:m]
    g.n = min(n, capacity)
    return g


def lookup(g: DBGraph, query_keys: torch.Tensor):
    """Batched lookup: (idx, found) per query key (..., W), through the
    hashed-bucket index (ops/hashidx.py)."""
    from ..ops import hashidx
    return hashidx.lookup(g.keys, query_keys)


def union_edges(g: DBGraph) -> torch.Tensor:
    """Per-kmer edge byte OR-ed across colours (population edges)."""
    from . import edges as E
    return E.union_colours(g.edges)


_uedges_cache: dict = {}


def cached_union_edges(g: DBGraph) -> torch.Tensor:
    """union_edges memoised on the edges tensor (checked with `is`), so
    the identity-keyed caches downstream (unitigs.cached_unitig_view)
    can hit."""
    ck = id(g.edges)
    hit = _uedges_cache.get(ck)
    if hit is not None and hit[0] is g.edges:
        return hit[1]
    ue = union_edges(g)
    if len(_uedges_cache) > 4:
        _uedges_cache.clear()
    _uedges_cache[ck] = (g.edges, ue)
    return ue


def compacted(g: DBGraph, align: int = 1 << 16) -> DBGraph:
    """Slice the store down to its live prefix, keeping the capacity a
    multiple of `align`."""
    cap = max(align, (g.n + align - 1) // align * align)
    if cap >= g.capacity:
        return g
    return DBGraph(keys=g.keys[:cap], covg=g.covg[:cap],
                   edges=g.edges[:cap], n=g.n, k=g.k)

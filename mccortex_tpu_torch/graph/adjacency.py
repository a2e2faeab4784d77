"""Precomputed vertex adjacency; counterpart of
mccortex_tpu/graph/adjacency.py.

adj[4*v + n] = vertex (2*row + orient) reached from vertex v by
appending base n, or -1 if that kmer is absent: built once per store
with 8 batched lookups over every row (ops/hashidx.py, on a CUDA store
the lookup kernel), then one gather per candidate.  Memoised per key
tensor.
"""

from __future__ import annotations

import torch

from ..ops import hashidx
from ..ops import kmer as kops
from ..utils.memo import Memo
from ..utils.timing import span
from . import store as gstore


def _probe(keys: torch.Tensor, k: int, o: int, n: int):
    """Canonical key + orientation of the (o, n) neighbour of every kmer."""
    okm = keys if o == 0 else kops.revcmp(keys, k)
    nxt = kops.shift_append(okm, torch.full(keys.shape[:1], n,
                                            dtype=torch.int64,
                                            device=keys.device), k)
    return kops.canonical(nxt, k)


def _vertex_of(idx: torch.Tensor, found: torch.Tensor, o2: torch.Tensor):
    return torch.where(found, idx * 2 + o2.to(torch.int32), -1).to(
        torch.int32)


def build_adjacency(keys: torch.Tensor, k: int) -> torch.Tensor:
    """adj flat (8N,) int32: adj[4*v + n] = next vertex from vertex v
    appending base n (v = 2*row + orient), -1 if absent."""
    N = keys.shape[0]
    with span("adjacency", keys.device):
        flat = torch.full((8 * N,), -1, dtype=torch.int32,
                          device=keys.device)
        for o in (0, 1):
            for n in range(4):
                key2, o2 = _probe(keys, k, o, n)
                j, found = hashidx.lookup(keys, key2)
                flat[o * 4 + n::8] = _vertex_of(j, found, o2)
    return flat


def adj_at(adj: torch.Tensor, v: torch.Tensor, n) -> torch.Tensor:
    """adj[4*v + n] for vertex tensor v and an int or tensor n."""
    if isinstance(n, int):
        return adj[v.to(torch.int64) * 4 + n]
    return adj[v.to(torch.int64) * 4 + n.to(torch.int64)]


_adjacency = Memo()


def cached_adjacency_for(keys: torch.Tensor, k: int):
    """The memoised adjacency for this key tensor, or None (never builds)."""
    return _adjacency.peek((keys,), keys.shape[0], k)


def get_adjacency_for(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The adjacency memoised on the key tensor itself: every graph phase
    walks one store's adjacency many times."""
    return _adjacency.get((keys,), lambda: build_adjacency(keys, k),
                          keys.shape[0], k)


def get_adjacency(g: gstore.DBGraph) -> torch.Tensor:
    return get_adjacency_for(g.keys, g.k)

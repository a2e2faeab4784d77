"""Node removal with edge-consistent cleanup; counterpart of
mccortex_tpu/graph/prune.py (ref src/graph/prune_nodes.c): delete kmers
not in a keep mask and clear every edge bit, in every colour, that
points at a deleted kmer."""

from __future__ import annotations

import torch

from ..ops import sorted as sops
from ..utils.timing import span
from . import adjacency as adjmod
from . import store as gstore


def clear_dangling_edges(keys: torch.Tensor, edges: torch.Tensor,
                         keep: torch.Tensor, k: int) -> torch.Tensor:
    """Clear, per colour, any edge bit whose neighbour kmer is not kept
    (through the cached adjacency of keys)."""
    return _clear_dangling_adj(edges, keep, adjmod.get_adjacency_for(keys, k))


def _clear_dangling_adj(edges: torch.Tensor, keep: torch.Tensor,
                        adj: torch.Tensor) -> torch.Tensor:
    N = edges.shape[0]
    idx = torch.arange(N, dtype=torch.int64, device=edges.device)
    new_edges = edges
    for o in (0, 1):
        for n in range(4):
            bit = 1 << (n + 4 * o)
            nv = adjmod.adj_at(adj, idx * 2 + o, n).to(torch.int64)
            neighbour_kept = (nv >= 0) & keep[nv.clamp(min=0) >> 1]
            new_edges = torch.where(neighbour_kept[:, None], new_edges,
                                    new_edges & (0xFF ^ bit))
    return new_edges


def prune_to_mask(g: gstore.DBGraph, keep: torch.Tensor,
                  k: int | None = None) -> gstore.DBGraph:
    """A new store holding only the kmers where keep is True, with
    dangling edges cleared.  Capacity is preserved; keys stay sorted
    because the compaction (target slot = exclusive prefix sum of keep)
    keeps their order."""
    k = k or g.k
    with span("prune", g.device):
        keep = keep & ~sops.is_sentinel(g.keys)
        edges = clear_dangling_edges(g.keys, g.edges, keep, k)
        out = gstore.empty(k, g.capacity, g.ncols, g.device)
        tgt = torch.cumsum(keep, 0)[keep] - 1
        out.keys[tgt] = g.keys[keep]
        out.covg[tgt] = g.covg[keep]
        out.edges[tgt] = edges[keep]
        out.n = int(tgt.shape[0])
    return out

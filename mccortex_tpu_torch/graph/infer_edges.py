"""Edge inference; counterpart of mccortex_tpu/graph/infer_edges.py (role
of ref src/tools/infer_edges.c).

--pop: for each kmer, any edge present in some colour (union) but not all
(intersection) is added to every colour where both endpoint kmers have
coverage.  --all: every edge bit not already in the intersection is
probed; if the neighbour kmer exists, the edge is added per colour where
both endpoints have coverage.  Each kmer probes its own candidate bits,
through the cached adjacency (ref infer_edges.c:26-90).
"""

from __future__ import annotations

import dataclasses

import torch

from . import adjacency as adjmod
from . import store as gstore


def infer_edges(g: gstore.DBGraph, pop_only: bool = True,
                k: int | None = None) -> gstore.DBGraph:
    return _infer_adj(g, adjmod.get_adjacency(g), pop_only)


def _infer_adj(g: gstore.DBGraph, adj: torch.Tensor, pop_only: bool = True):
    N = g.capacity
    edges = g.edges
    uedges = gstore.union_edges(g)
    iedges = edges[:, 0]
    for c in range(1, edges.shape[1]):
        iedges = iedges & edges[:, c]
    cand = (uedges & ~iedges) if pop_only else ~iedges
    present = g.covg != 0          # (N, C); covg holds uint32 bit views
    idx = torch.arange(N, dtype=torch.int64, device=g.device)
    new_edges = edges
    for o in (0, 1):
        for n in range(4):
            bit = 1 << (n + 4 * o)
            rows = (cand & bit) != 0
            nv = adjmod.adj_at(adj, idx * 2 + o, n)
            j = nv.clamp(min=0).long() >> 1
            addc = (rows & (nv >= 0))[:, None] & present & present[j]
            new_edges = torch.where(addc, new_edges | bit, new_edges)
    return dataclasses.replace(g, edges=new_edges)

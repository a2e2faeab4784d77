"""Subgraph extraction: the BFS neighbourhood of seed kmers; counterpart
of mccortex_tpu/graph/subgraph.py (role of ref src/tools/subgraph.c).

Mark the kmers within `dist` steps of any seed-sequence kmer, optionally
whole unitigs (--unitigs) or the complement (--invert), then prune.  The
BFS frontier is the boolean mark vector itself: one step expands all 8
neighbours of every marked kmer at once.  The scatters that OR marks
into rows (several sources may hit one row) are scatter-max on int32, so
a False never overwrites a True.
"""

from __future__ import annotations

import torch

from ..ops import hashidx
from ..ops import kmer as kops
from ..ops import sorted as sops
from . import adjacency as adjmod
from . import edges as E
from . import store as gstore


def _scatter_or(n: int, idx: torch.Tensor, val: torch.Tensor
                ) -> torch.Tensor:
    """(n,) bool: True where some val at that index is True."""
    out = torch.zeros((n,), dtype=torch.int32, device=val.device)
    out.scatter_reduce_(0, idx.long().reshape(-1),
                        val.reshape(-1).to(torch.int32), "amax")
    return out != 0


def bfs_mark(g: gstore.DBGraph, seed_mask: torch.Tensor, dist: int, k: int):
    """Expand seed_mask by `dist` BFS steps over graph edges (adjacency
    gathers)."""
    adj = adjmod.get_adjacency(g)
    uedges = gstore.union_edges(g)
    mask = seed_mask
    for _ in range(dist):
        mask = _bfs_step(mask, uedges, adj)
    return mask & ~sops.is_sentinel(g.keys)


def _bfs_step(mask, uedges, adj):
    N = mask.shape[0]
    idx = torch.arange(N, dtype=torch.int64, device=mask.device)
    out = mask
    for o in (0, 1):
        nib = E.with_orientation(uedges, o)
        for n in range(4):
            has = ((nib >> n) & 1).to(torch.bool) & mask
            nv = adjmod.adj_at(adj, idx * 2 + o, n)
            out = out | _scatter_or(N, nv.clamp(min=0) >> 1, has & (nv >= 0))
    return out


def seed_mask_from_seqs(g: gstore.DBGraph, seq_batches) -> torch.Tensor:
    """(N,) bool: the store rows of every kmer of the sequences (batches
    of base codes (B, L) uint8), probed through hashidx.lookup (on a CUDA
    store the lookup kernel)."""
    mask = torch.zeros((g.capacity,), dtype=torch.bool, device=g.device)
    for bases in seq_batches:
        kmers, valid = kops.rolling_kmers(
            torch.as_tensor(bases, device=g.device), g.k)
        keys, _ = kops.canonical(kmers, g.k)
        idx, found = hashidx.lookup(g.keys, keys.reshape(-1, g.W))
        mask = mask | _scatter_or(g.capacity, idx, valid.reshape(-1) & found)
    return mask


def subgraph(g: gstore.DBGraph, seq_batches, dist: int = 0,
             invert: bool = False, whole_unitigs: bool = False):
    from . import prune as P
    from . import unitigs as U
    mask = seed_mask_from_seqs(g, seq_batches)
    if whole_unitigs:
        uv = U.unitig_view(g.keys, gstore.union_edges(g), g.k)
        # mark whole unitigs holding any marked kmer
        hit = _scatter_or(2 * g.capacity, uv.uid, mask)
        mask = hit[uv.uid.long()]
    mask = bfs_mark(g, mask, dist, g.k)
    if invert:
        mask = ~mask & ~sops.is_sentinel(g.keys)
    return P.prune_to_mask(g, mask)

"""Unitigs via pointer doubling; counterpart of
mccortex_tpu/graph/unitigs.py.

Every kmer is a pair of vertices v = 2*row + orient in a functional
digraph with in/out degree <= 1 (chains + cycles); unitig membership,
ends and positions are resolved for all kmers at once in O(log N)
pointer-jumping passes.  succ[v] = the vertex one step along the unitig
in that orientation, or -1 where the unitig ends (junction, dead end,
hairpin or self-loop; ref db_unitig.c:100-120).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kmer as kops
from ..ops import sorted as sops
from ..utils.memo import Memo
from ..utils.timing import span
from . import adjacency as adjmod
from . import edges as E
from . import store as gstore

# nibble (popcount == 1) -> nucleotide
_NIB2NUC = np.array([0, 0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0],
                    dtype=np.uint8)


@dataclasses.dataclass
class UnitigView:
    """Per-kmer unitig labelling."""
    succ: torch.Tensor      # (2N,) int32, -1 = end of unitig
    end: torch.Tensor       # (2N,) int32 terminal vertex (self if end)
    dist: torch.Tensor      # (2N,) int32 steps to end (cycle: unspecified)
    uid: torch.Tensor       # (N,) int32 unitig id (a representative vertex)
    is_cycle: torch.Tensor  # (N,) bool
    length: torch.Tensor    # (N,) int32 unitig length in kmers


def successors(keys: torch.Tensor, uedges: torch.Tensor, k: int
               ) -> torch.Tensor:
    """succ (2N,) for all kmer-orientation vertices, from the (cached)
    adjacency; uedges is the union (across colours) edge byte per kmer."""
    return _successors_from_adj(uedges, adjmod.get_adjacency_for(keys, k))


def _successors_from_adj(uedges: torch.Tensor, adj: torch.Tensor):
    N = uedges.shape[0]
    dev = uedges.device
    nib2nuc = E.table(_NIB2NUC, dev).to(torch.int64)
    pop4 = E.table(E.POPCOUNT4, dev)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    succ = torch.full((2 * N,), -1, dtype=torch.int32, device=dev)
    for o in (0, 1):
        nib = E.with_orientation(uedges, o).to(torch.int64)
        single = pop4[nib] == 1
        nv = adjmod.adj_at(adj, idx * 2 + o, nib2nuc[nib]).to(torch.int64)
        found = nv >= 0
        j = nv.clamp(min=0) >> 1
        o2 = nv.clamp(min=0) & 1
        nib_in = E.with_orientation(uedges[j], 1 - o2).to(torch.int64)
        indeg1 = pop4[nib_in] == 1
        ok = single & found & indeg1 & (j != idx)
        succ[o::2] = torch.where(ok, j * 2 + o2, -1).to(torch.int32)
    return succ


_PD_DMASK = 0xFFFFFFFF


def pointer_doubling(succ: torch.Tensor):
    """Resolve (end, dist, minvertex) for every vertex in O(log V) passes.

    For chain vertices `end` is the terminal vertex and `dist` the exact
    number of steps to it.  For cycle vertices (succ[end] != -1) `minv`
    is the minimum vertex id on the whole cycle.  (p, d) travel packed
    as (p << 32) | d in one int64 (p < 2**31, so it stays non-negative),
    one gather per pass.  The per-pass change count is strictly
    decreasing while any chain is unconverged, so the loop stops at two
    equal consecutive counts; each count is read one pass later, as the
    JAX package reads it, so the loop leaves at the same pass (the end
    of a cycle vertex depends on it).  Cycle minima are resolved on the
    host over the compacted cycle subset.
    """
    V = succ.shape[0]
    dev = succ.device
    steps = max(1, int(np.ceil(np.log2(max(V, 2)))) + 1)
    with span("doubling", dev):
        pk = _pd_init(succ)
        prev_cnt = None
        pending = None
        for _ in range(steps):
            pk, changed = _pd_step_packed(pk)
            if pending is not None:
                cnt = int(pending)
                if prev_cnt is not None and cnt == prev_cnt:
                    break
                prev_cnt = cnt
            pending = changed
        p, d = _pd_unpack(pk)
        cyc_mask = _pd_cyc_mask(succ, p)
        m = torch.arange(V, dtype=torch.int32, device=dev)
        if bool(cyc_mask.any()):
            cyc = cyc_mask.cpu().numpy()
            idx = np.nonzero(cyc)[0].astype(np.int64)
            sub_succ = succ.cpu().numpy()[idx]
            # every cycle successor is a cycle vertex: searchsorted is exact
            sub = np.searchsorted(idx, sub_succ)
            sub_m = idx.astype(np.int64)
            for _ in range(max(1, int(np.ceil(np.log2(max(len(idx), 2))))
                            + 1)):
                sub_m = np.minimum(sub_m, sub_m[sub])
                sub = sub[sub]
            m_np = np.arange(V, dtype=np.int32)
            m_np[idx] = sub_m.astype(np.int32)
            m = torch.from_numpy(m_np).to(dev)
    return p, d, m


def _pd_init(succ: torch.Tensor) -> torch.Tensor:
    iota = torch.arange(succ.shape[0], dtype=torch.int64, device=succ.device)
    s = succ.to(torch.int64)
    p = torch.where(s < 0, iota, s)
    d = (s >= 0).to(torch.int64)
    return (p << 32) | d


def _pd_step_packed(pk: torch.Tensor):
    at = pk[pk >> 32]
    d = torch.clamp((pk & _PD_DMASK) + (at & _PD_DMASK), max=_PD_DMASK)
    new = (at & ~_PD_DMASK) | d
    return new, (new != pk).sum()


def _pd_unpack(pk: torch.Tensor):
    return (pk >> 32).to(torch.int32), (pk & _PD_DMASK).to(torch.int32)


def _pd_cyc_mask(succ: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return succ[p.to(torch.int64)] >= 0


def unitig_view(keys: torch.Tensor, uedges: torch.Tensor, k: int
                ) -> UnitigView:
    succ = successors(keys, uedges, k)
    end, dist, minv = pointer_doubling(succ)
    return _view_finish(keys, succ, end, dist, minv)


_views = Memo()


def cached_unitig_view(keys: torch.Tensor, uedges: torch.Tensor,
                       k: int) -> UnitigView:
    """unitig_view memoised on the (keys, uedges) tensors, so clean's
    stats and pruning share one doubling pass."""
    return _views.get((keys, uedges), lambda: unitig_view(keys, uedges, k),
                      k)


def _view_finish(keys, succ, end, dist, minv) -> UnitigView:
    N = keys.shape[0]
    e0, e1 = end[0::2].to(torch.int64), end[1::2].to(torch.int64)
    d0, d1 = dist[0::2], dist[1::2]
    cyc = succ[e0] >= 0  # chains end at a vertex with no successor
    uid_chain = torch.minimum(e0, e1)
    uid_cycle = torch.minimum(minv[0::2], minv[1::2]).to(torch.int64)
    uid = torch.where(cyc, uid_cycle, uid_chain)
    length = torch.where(cyc, 0, d0 + d1 + 1).to(torch.int32)
    # cycle length = number of live kmers with this uid
    ones = (~sops.is_sentinel(keys)).to(torch.int32)
    counts = torch.zeros(2 * N, dtype=torch.int32, device=keys.device)
    counts.index_add_(0, uid, ones)
    length = torch.where(cyc, counts[uid], length)
    return UnitigView(succ=succ, end=end, dist=dist,
                      uid=uid.to(torch.int32), is_cycle=cyc, length=length)


def unitig_stats(g: gstore.DBGraph, k: int | None = None):
    """(uid view, median_sum_covg, is_tip, extdeg_sum) per kmer.

    median coverage = median over the unitig's kmers of per-kmer
    sum-across-colours coverage (ref clean_graph.c:388); tip: external
    degree at the two ends sums to <= 1 (ref clean_graph.c:289).
    median (int64) holds the uint32 values of the JAX package's."""
    k = k or g.k
    uedges = gstore.cached_union_edges(g)
    uv = cached_unitig_view(g.keys, uedges, k)
    return _stats_finish(g.keys, g.covg, uedges, uv)


def _stats_finish(keys, covg, uedges, uv: UnitigView):
    N = keys.shape[0]
    dev = keys.device
    sumcovg = (covg.to(torch.int64) & 0xFFFFFFFF).sum(dim=1) & 0xFFFFFFFF
    live = ~sops.is_sentinel(keys)
    uid = uv.uid.to(torch.int64)

    # median: sort (uid, covg), then index the middle of each segment
    perm = sops.argsort_planes(torch.stack([uv.uid, sumcovg.to(torch.int32)]))
    s_uid = uid[perm]
    s_covg = sumcovg[perm]
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = s_uid[1:] != s_uid[:-1]
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    start_of = torch.full((2 * N,), torch.iinfo(torch.int64).min,
                          dtype=torch.int64, device=dev)
    start_of = start_of.scatter_reduce(0, s_uid, torch.where(first, pos, 0),
                                       "amax")
    ln = uv.length.to(torch.int64)
    start = start_of[uid]
    # gca_median: odd -> mid; even -> mean of the two middles (floor)
    mid_hi = (start + ln // 2).clamp(0, N - 1)
    mid_lo = (start + (ln - 1) // 2).clamp(0, N - 1)
    median = (s_covg[mid_lo] + s_covg[mid_hi]) // 2

    # external degree at the unitig's two ends
    pop4 = E.table(E.POPCOUNT4, dev)

    def extdeg(v):
        v = v.to(torch.int64)
        nib = E.with_orientation(uedges[v >> 1], v & 1)
        return pop4[nib.to(torch.int64)].to(torch.int32)

    ext = extdeg(uv.end[0::2]) + extdeg(uv.end[1::2])
    # end0 != end1 for every chain, even a single kmer: no double count
    is_tip = (~uv.is_cycle) & (ext <= 1) & live
    return uv, median, is_tip, ext


# ---------------------------------------------------------------------------
# host-side unitig sequence extraction (for `mctx-torch unitigs`)
# ---------------------------------------------------------------------------

def _oriented_np(keys: np.ndarray, orient: np.ndarray, k: int) -> np.ndarray:
    """kops.oriented on host uint64 rows (through CPU tensors)."""
    return kops.oriented(torch.from_numpy(keys.view(np.int64)),
                         torch.from_numpy(orient.astype(np.uint8)),
                         k).numpy().view(np.uint64)


def extract_unitigs(g: gstore.DBGraph):
    """Unitig sequences (strings), normalised like ref
    db_unitig_normalise: linear unitigs start from the end with the
    smaller kmer key; cycles start at their lowest kmer key in FORWARD
    orientation.  Order: by unitig id (deterministic)."""
    from ..utils.text import kmers_to_strings
    n = g.n
    if n == 0:
        return []
    k = g.k
    uv = unitig_view(g.keys, gstore.union_edges(g), k)
    with span("extract"):
        succ = uv.succ.cpu().numpy()
        end = uv.end.cpu().numpy()
        dist = uv.dist.cpu().numpy()
        uid = uv.uid.cpu().numpy()[:n]
        cyc = uv.is_cycle.cpu().numpy()[:n]
        length = uv.length.cpu().numpy()[:n]
        keys = g.keys.cpu().numpy().view(np.uint64)
        out = []
        # chains: ordered by (uid, position along the unitig)
        chain_rows = np.nonzero(~cyc)[0]
        if len(chain_rows):
            e0, e1 = end[2 * chain_rows], end[2 * chain_rows + 1]
            k0, k1 = keys[e0 >> 1], keys[e1 >> 1]
            lt = _rows_lt(k0, k1)
            eq = (k0 == k1).all(axis=1)
            # start end = smaller key; on a tie (one kmer) the
            # orientation-1 end, so the kmer is emitted FORWARD
            e_start = np.where(lt, e0, e1)
            tie_pick = np.where((e0 & 1) == 1, e0, e1)
            e_start = np.where(eq, tie_pick, e_start)
            e_target = np.where(e_start == e0, e1, e0)
            o_along = np.where(end[2 * chain_rows] == e_target, 0, 1)
            v_along = 2 * chain_rows + o_along
            pos = length[chain_rows] - 1 - dist[v_along]
            order = np.lexsort((pos, uid[chain_rows]))
            rows_o = chain_rows[order]
            okm = _oriented_np(keys[rows_o], o_along[order], k)
            lastc = np.frombuffer(b"ACGT", np.uint8)[
                (okm[:, -1] & np.uint64(3)).astype(np.int64)].tobytes()
            u_sorted = uid[rows_o]
            starts = np.nonzero(np.concatenate(
                [[True], u_sorted[1:] != u_sorted[:-1]]))[0]
            firsts = kmers_to_strings(okm[starts], k)
            bounds = np.append(starts, len(u_sorted))
            for first, s, e in zip(firsts, bounds[:-1], bounds[1:]):
                out.append(first + lastc[s + 1:e].decode())
        # cycles: a walk per cycle (rare, usually small)
        cyc_rows = np.nonzero(cyc)[0]
        if len(cyc_rows):
            rows = cyc_rows.tolist()
            okm = _oriented_np(np.concatenate([keys[cyc_rows]] * 2),
                               np.repeat(np.array([0, 1]), len(rows)), k)
            last_base = dict(zip([2 * r for r in rows] +
                                 [2 * r + 1 for r in rows],
                                 (okm[:, -1] & np.uint64(3)).tolist()))

            def last_of(v):
                if v not in last_base:     # a walk that leaves the cycle set
                    last_base[v] = int(_oriented_np(
                        keys[v >> 1][None], np.array([v & 1]), k)[0, -1] & 3)
                return last_base[v]

            for u in np.unique(uid[cyc_rows]):
                members = cyc_rows[uid[cyc_rows] == u]
                # start at the lowest key, FORWARD
                lowest = int(members[_rows_argmin(keys[members])])
                v = 2 * lowest
                nucs = [kmers_to_strings(keys[lowest][None], k)[0]]
                while True:
                    v = int(succ[v])
                    if v < 0 or (v >> 1) == lowest:
                        break
                    nucs.append("ACGT"[last_of(v)])
                out.append("".join(nucs))
    return out


def _rows_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic row compare for (N, W) uint64."""
    W = a.shape[1]
    lt = a[:, W - 1] < b[:, W - 1]
    for w in range(W - 2, -1, -1):
        lt = (a[:, w] < b[:, w]) | ((a[:, w] == b[:, w]) & lt)
    return lt


def _rows_argmin(a: np.ndarray) -> int:
    best = 0
    for i in range(1, len(a)):
        if tuple(a[i]) < tuple(a[best]):
            best = i
    return best

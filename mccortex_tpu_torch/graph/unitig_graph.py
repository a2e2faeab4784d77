"""Unitig-level graph export: GFA v1 and graphviz DOT; counterpart of
mccortex_tpu/graph/unitig_graph.py (ref src/graph/unitig_graph.c):
unitigs become segments; links join unitig ends that share a
(k-1)-overlap edge in the kmer graph.  Host code: the kmer arithmetic
runs on CPU tensors, one batch for all unitig ends.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CHAR_TO_BASE
from ..ops import kmer as kops
from . import store as gstore
from .unitigs import _rows_lt


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _find_rows(keys_np: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Row of each query key (Q, W) in the sorted store keys, or -1."""
    N = len(keys_np)
    lo = np.zeros(len(q), np.int64)
    hi = np.full(len(q), N, np.int64)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) // 2
        less = act & _rows_lt(keys_np[np.minimum(mid, N - 1)], q)
        lo = np.where(less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    hit = lo < N
    hit[hit] = (keys_np[lo[hit]] == q[hit]).all(axis=1)
    return np.where(hit, lo, -1)


def unitig_links(g: gstore.DBGraph, seqs):
    """For unitig sequences, the directed links (i, side_i, j, side_j):
    side 0 = the unitig's start (left/5'), 1 = its end (right/3').  A
    link (i, 1) -> (j, 0) means unitig i read forward continues into
    unitig j read forward, overlapping k-1 bases."""
    k = g.k
    if not seqs:
        return []
    U = len(seqs)

    def codes(part):
        return torch.from_numpy(np.stack([
            CHAR_TO_BASE[np.frombuffer(part(s).encode(), np.uint8)]
            for s in seqs]))

    fk = kops.pack_kmers(codes(lambda s: s[:k]), k)
    lk = kops.pack_kmers(codes(lambda s: s[-k:]), k)
    fkey, fo = kops.canonical(fk, k)
    lkey, lo = kops.canonical(lk, k)
    fkey, lkey = _u64(fkey), _u64(lkey)
    # index: key row -> (unitig, which end, orientation of seq at that end)
    end_index = {}
    for i in range(U):
        end_index.setdefault(tuple(fkey[i]), []).append((i, 0, int(fo[i])))
        end_index.setdefault(tuple(lkey[i]), []).append((i, 1, int(lo[i])))

    uedges = gstore.union_edges(g).cpu().numpy()
    keys_np = g.keys.cpu().numpy().view(np.uint64)
    # walking out of side 1 goes forward past the last kmer; out of side
    # 0, backward (reverse strand) from the first: rows [0, U) are side
    # 1, rows [U, 2U) side 0
    kmer = torch.cat([lk, kops.revcmp(fk, k)])
    key, orient = kops.canonical(kmer, k)
    rows = _find_rows(keys_np, _u64(key))
    orient = orient.numpy().astype(np.int64)
    nib = np.where(rows >= 0,
                   (uedges[np.maximum(rows, 0)] >> (4 * orient)) & 0xF, 0)
    links = set()
    for n in range(4):
        r_out = np.nonzero((nib >> n) & 1)[0]
        if not len(r_out):
            continue
        nxt = kops.shift_append(kmer[r_out], torch.full(
            (len(r_out),), n, dtype=torch.int64), k)
        nkey, norient = kops.canonical(nxt, k)
        nkey = _u64(nkey)
        for r, key_row, no in zip(r_out.tolist(), nkey, norient.tolist()):
            i, side = (r, 1) if r < U else (r - U, 0)
            for (j, jside, jor) in end_index.get(tuple(key_row), []):
                # entering unitig j: at its start kmer in the sequence's
                # orientation reads j forward (enter side 0); at its end
                # kmer against the sequence's orientation reads j backward
                enter_fwd = jside == 0 and jor == no
                enter_rev = jside == 1 and jor != no
                if enter_fwd or enter_rev:
                    links.add((i, side, j, 0 if enter_fwd else 1))
    return sorted(links)


def write_gfa(out, g: gstore.DBGraph, seqs):
    out.write("H\tVN:Z:1.0\n")
    for i, s in enumerate(seqs):
        out.write(f"S\tunitig{i}\t{s}\n")
    for (i, si, j, sj) in unitig_links(g, seqs):
        # side 1 -> forward out of i; entering side 0 -> forward into j
        oi = "+" if si == 1 else "-"
        oj = "+" if sj == 0 else "-"
        out.write(f"L\tunitig{i}\t{oi}\tunitig{j}\t{oj}\t{g.k - 1}M\n")


def write_dot(out, g: gstore.DBGraph, seqs, points: bool = False):
    """Graphviz output (ref ctx_unitigs.c --dot: nodes with :n/:s ports;
    --points draws unitigs as unlabelled points)."""
    out.write("digraph G {\n  edge [dir=both arrowhead=none arrowtail=none]\n")
    if points:
        out.write("  node [shape=point label=none]\n")
    for i, s in enumerate(seqs):
        if points:
            out.write(f"  unitig{i}\n")
        else:
            out.write(f"  unitig{i} [label=\"{s if len(s) <= 30 else str(len(s)) + 'bp'}\"]\n")
    for (i, si, j, sj) in unitig_links(g, seqs):
        pi = "e" if si == 1 else "w"
        pj = "w" if sj == 0 else "e"
        out.write(f"  unitig{i}:{pi} -> unitig{j}:{pj}\n")
    out.write("}\n")

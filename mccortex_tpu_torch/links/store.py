"""Link (path) store: CSR over kmer-orientation vertices; counterpart of
mccortex_tpu/links/store.py (role of ref src/paths/gpath_store.{c,h}).

Vertex v = 2*kmer_row + orient -> rows [offsets[v], offsets[v+1]) of
(seq, nj, nseen[C]).  Junction sequences are 2-bit packed into JW 64-bit
words, the FIRST junction in the top bits of word 0 (the kmers'
big-endian convention), so that lexicographic word order is
junction-string order.  On the device the words travel as int64 bit
views of the uint64 words and the seen counts as int32 bit views of
uint32; the aggregation (sort, dedup, CSR) runs on the host in numpy, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class LinkStore:
    offsets: torch.Tensor  # (2N+1,) int32 CSR offsets per vertex
    seq: torch.Tensor      # (L, JW) int64 (uint64 bits) packed junctions
    nj: torch.Tensor       # (L,) int32 junction count
    nseen: torch.Tensor    # (L, C) int32 (uint32 bits) per-colour counts

    @property
    def nlinks(self) -> int:
        return self.seq.shape[0]

    @property
    def jwords(self) -> int:
        return self.seq.shape[1]

    @property
    def max_juncs(self) -> int:
        return self.seq.shape[1] * 32

    @property
    def device(self) -> torch.device:
        return self.offsets.device


def to_host(ls: LinkStore):
    """(offsets int32, seq (L, JW) uint64, nj int32, nseen (L, C) uint32)
    numpy arrays, as the JAX package's LinkStore holds them."""
    return (ls.offsets.cpu().numpy(), ls.seq.cpu().numpy().view(np.uint64),
            ls.nj.cpu().numpy(), ls.nseen.cpu().numpy().view(np.uint32))


def from_host(offsets: np.ndarray, seq: np.ndarray, nj: np.ndarray,
              nseen: np.ndarray, device="cuda") -> LinkStore:
    """A store on `device` from host arrays (seq uint64, nseen uint32)."""
    def t(a, dtype, view):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(dtype, copy=False)).view(view)).to(device)
    return LinkStore(offsets=t(offsets, np.int32, np.int32),
                     seq=t(seq, np.uint64, np.int64),
                     nj=t(nj, np.int32, np.int32),
                     nseen=t(nseen, np.uint32, np.int32))


def empty(N: int, ncols: int, jwords: int = 1, device="cuda") -> LinkStore:
    return from_host(np.zeros((2 * N + 1,), np.int32),
                     np.zeros((0, jwords), np.uint64), np.zeros((0,), np.int32),
                     np.zeros((0, ncols), np.uint32), device)


def pack_juncs(bases: np.ndarray, nj: np.ndarray, jwords: int) -> np.ndarray:
    """Pack junction base arrays (L, Jmax) uint8 (first junction first)
    into (L, jwords) uint64, first junction at the TOP of word 0; bases
    beyond nj are zeroed."""
    L, Jmax = bases.shape
    out = np.zeros((L, jwords), np.uint64)
    j = np.arange(Jmax)
    mask = j[None, :] < nj[:, None]
    b = np.where(mask, bases & 3, 0).astype(np.uint64)
    for idx in range(min(Jmax, jwords * 32)):
        w = idx // 32
        sh = np.uint64(62 - 2 * (idx % 32))
        out[:, w] |= b[:, idx] << sh
    return out


def unpack_junc(seq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Junction base at position pos (device): seq (L_, JW) int64, pos
    (L_,); pos 0 = first junction (top of word 0).  The shift is at most
    62, so the two bits read are the word's own whatever the sign."""
    pos = pos.long()
    sh = 62 - 2 * (pos % 32)
    w = (pos // 32).clamp(0, seq.shape[1] - 1)
    words = torch.gather(seq, 1, w[:, None])[:, 0]
    return ((words >> sh) & 3).to(torch.uint8)


def build_store(g_keys: torch.Tensor, link_rows: np.ndarray,
                link_orients: np.ndarray, link_bases: np.ndarray,
                link_nj: np.ndarray, link_colours: np.ndarray,
                ncols: int) -> LinkStore:
    """Aggregate raw link records into a deduplicated CSR store on the
    device of g_keys.

    link_rows: (L,) kmer row in the graph store; link_orients: (L,) 0/1;
    link_bases: (L, Jmax) uint8 junction bases; link_nj: (L,) counts;
    link_colours: (L,) colour of each record.  Records with nj <= 0 are
    dropped.  Duplicate (vertex, seq) records are merged with per-colour
    nseen counts (role of ref gpath_hash_find_or_insert_mt).
    """
    N = g_keys.shape[0]
    keep = link_nj > 0
    rows = link_rows[keep].astype(np.int64)
    orients = link_orients[keep].astype(np.int64)
    bases = link_bases[keep]
    nj = link_nj[keep].astype(np.int64)
    cols = link_colours[keep].astype(np.int64)
    L = len(rows)
    jwords = max(1, int(np.ceil((nj.max() if L else 1) / 32)))
    seq = pack_juncs(bases, nj, jwords) if L else np.zeros((0, jwords),
                                                           np.uint64)
    vert = rows * 2 + orients
    order = _order(vert, nj, seq)
    vert, nj, seq, cols = vert[order], nj[order], seq[order], cols[order]
    first = _firsts(vert, nj, seq)
    uid = np.cumsum(first) - 1
    U = int(uid[-1]) + 1 if L else 0
    nseen = np.zeros((U, ncols), np.uint32)
    np.add.at(nseen, (uid, cols), 1)
    u_first = np.nonzero(first)[0]
    return assemble_csr(vert[u_first], seq[u_first], nj[u_first], nseen, N,
                        g_keys.device)


def _order(vert, nj, seq) -> np.ndarray:
    """Permutation sorting records by (vertex, nj, seq words)."""
    jw = seq.shape[1]
    return np.lexsort(tuple(seq[:, w] for w in range(jw - 1, -1, -1))
                      + (nj, vert))


def _firsts(vert, nj, seq) -> np.ndarray:
    """True at the first record of each run of equal (vertex, nj, seq)."""
    if not len(vert):
        return np.zeros((0,), bool)
    same = (vert[1:] == vert[:-1]) & (nj[1:] == nj[:-1]) & \
        (seq[1:] == seq[:-1]).all(axis=1)
    return np.concatenate([[True], ~same])


def assemble_csr(vert: np.ndarray, seq: np.ndarray, nj: np.ndarray,
                 nseen: np.ndarray, N: int, device="cuda") -> LinkStore:
    """The CSR store from unique link records, sorted by vertex."""
    order = np.argsort(vert, kind="stable")
    vert, seq, nj, nseen = vert[order], seq[order], nj[order], nseen[order]
    counts = np.bincount(vert, minlength=2 * N)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return from_host(offsets, seq, nj, nseen, device)


def _link_verts(offsets: np.ndarray) -> np.ndarray:
    """The vertex of every link, from the CSR offsets."""
    return np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))


def merge_stores(a: LinkStore, b: LinkStore, N: int) -> LinkStore:
    """Merge two link stores over the same graph (role of ref pjoin /
    gpath_reader_load accumulation); on a's device."""
    ncols = max(a.nseen.shape[1], b.nseen.shape[1])
    jw = max(a.jwords, b.jwords)

    def widen(s: LinkStore):
        offs, sq, nj, ns = to_host(s)
        seq = np.zeros((s.nlinks, jw), np.uint64)
        seq[:, :s.jwords] = sq
        nsw = np.zeros((s.nlinks, ncols), np.uint32)
        nsw[:, :ns.shape[1]] = ns
        return _link_verts(offs), seq, nj, nsw

    va, sa, ja, na = widen(a)
    vb, sb, jb, nb = widen(b)
    vert = np.concatenate([va, vb])
    seq = np.concatenate([sa, sb])
    nj = np.concatenate([ja, jb])
    ns = np.concatenate([na, nb])
    order = _order(vert, nj, seq)
    vert, seq, nj, ns = vert[order], seq[order], nj[order], ns[order]
    L = len(vert)
    first = _firsts(vert, nj, seq)
    uid = np.cumsum(first) - 1
    U = int(uid[-1]) + 1 if L else 0
    nseen = np.zeros((U, ncols), np.uint64)
    np.add.at(nseen, (uid[:, None].repeat(ncols, 1),
                      np.arange(ncols)[None, :].repeat(L, 0)), ns)
    u = np.nonzero(first)[0]
    counts = np.bincount(vert[u], minlength=2 * N)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return from_host(offsets, seq[u], nj[u].astype(np.int32),
                     np.minimum(nseen, np.iinfo(np.uint32).max
                                ).astype(np.uint32), a.device)


def _prefix_eq(seq_i: np.ndarray, seq_j: np.ndarray, njj: int) -> bool:
    """True if the first njj junctions of both packed rows match."""
    full = njj // 32
    rem = njj % 32
    if full and not np.array_equal(seq_i[:full], seq_j[:full]):
        return False
    if rem:
        mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(64 - 2 * rem)
        return bool((seq_i[full] & mask) == (seq_j[full] & mask))
    return True


def rmsubstr_store(ls: LinkStore) -> LinkStore:
    """Remove redundant links (ref gpath_subset.c:106 rmsubstr, `pjoin
    -r`): within a vertex, exact duplicates merge their counts; a link
    that is a strict PREFIX of another loses the colours the longer link
    covers and is dropped once no colour remains.
    {A, C, CG, CGC} -> {A, CGC}."""
    L = ls.nlinks
    if L <= 1:
        return ls
    off, seq, nj, nseen = to_host(ls)
    nseen = nseen.copy()
    keep = np.ones(L, bool)
    for v in np.nonzero(np.diff(off) > 1)[0]:
        s, e = int(off[v]), int(off[v + 1])
        idxs = sorted(range(s, e),
                      key=lambda t: (tuple(seq[t].tolist()), int(nj[t])))
        for a in range(len(idxs) - 1, 0, -1):
            i = idxs[a]
            if not keep[i]:
                continue
            for q in range(a - 1, -1, -1):
                j = idxs[q]
                if not keep[j]:
                    continue
                if nj[j] > nj[i] or not _prefix_eq(seq[i], seq[j],
                                                   int(nj[j])):
                    break
                if nj[j] == nj[i]:
                    # exact duplicate: steal counts
                    nseen[i] += nseen[j]
                    keep[j] = False
                else:
                    # j is a strict prefix of i: remove shared colours
                    nseen[j][nseen[i] > 0] = 0
                    if not nseen[j].any():
                        keep[j] = False
    if keep.all():
        return ls
    counts = np.bincount(_link_verts(off)[keep], minlength=len(off) - 1)
    new_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return from_host(new_off, seq[keep], nj[keep], nseen[keep], ls.device)

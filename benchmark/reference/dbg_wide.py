"""A plain de Bruijn graph of one colour for kmers of any odd k <= 63,
held as two int64 words, worked out from McCortex's definitions with
torch alone (on the card or the CPU); it shares no code with the program.

A kmer is the 2k-bit number of its 2-bit codes (A, C, G, T = 0..3),
first base in the highest bits, held as McCortex's BinaryKmer holds it:
two words, (hi, lo), lo the last 32 bases (64 bits) and hi the bases
before them.  A word is an int64 holding the bits of the uint64 word, so
the unsigned order of lo is the signed order of lo ^ SIGN; hi has at
most 62 bits and is never negative.  For k <= 32, hi is 0 and a key is
dbg.py's.  Keys are the lesser of a kmer and its reverse complement, and
are kept in ascending (hi, lo) order, as a .ctx holds them.

Vertices, edge bytes, `clean -T -U` and unitigs are dbg.py's definitions
(see its docstring); the graph walks that see no key (unitig labels,
degrees, the cleaning threshold) are dbg.py's own functions.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dbg

BLOCK = 1 << 17          # reads a block in build
SIGN = -(1 << 63)        # the int64 bit pattern of 1 << 63
LOW62 = (1 << 62) - 1


def nwords(k: int) -> int:
    """Words a .ctx holds a kmer of size k in."""
    return (2 * k + 63) // 64


def _at(hi: torch.Tensor, lo: torch.Tensor, p: int) -> torch.Tensor:
    """The code at position p counted from the last base (0)."""
    return (lo >> (2 * p)) & 3 if p < 32 else (hi >> (2 * (p - 32))) & 3


def _put(hi, lo, p: int, code):
    """(hi, lo) with `code` or-ed in at position p from the last base."""
    if p < 32:
        return hi, lo | (code << (2 * p))
    return hi | (code << (2 * (p - 32))), lo


def lt(ahi, alo, bhi, blo) -> torch.Tensor:
    """(ahi, alo) < (bhi, blo), unsigned."""
    return (ahi < bhi) | ((ahi == bhi) & ((alo ^ SIGN) < (blo ^ SIGN)))


def order(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts keys (hi, lo) ascending."""
    o = torch.argsort(lo ^ SIGN, stable=True)
    return o[torch.argsort(hi[o], stable=True)]


def kmers_of(reads: torch.Tensor, k: int):
    """(hi, lo, orients) of every window of reads (B, L) int64 codes:
    each (B, L - k + 1); (hi, lo) the canonical key."""
    P = reads.shape[1] - k + 1
    z = torch.zeros((reads.shape[0], P), dtype=torch.int64,
                    device=reads.device)
    fh, fl, rh, rl = z, z.clone(), z.clone(), z.clone()
    for j in range(k):
        col = reads[:, j:j + P]
        fh, fl = _put(fh, fl, k - 1 - j, col)
        rh, rl = _put(rh, rl, j, 3 - col)
    rc_less = lt(rh, rl, fh, fl)
    return (torch.where(rc_less, rh, fh), torch.where(rc_less, rl, fl),
            rc_less.to(torch.int64))


def revcomp(hi: torch.Tensor, lo: torch.Tensor, k: int):
    oh, ol = torch.zeros_like(hi), torch.zeros_like(lo)
    for p in range(k):
        oh, ol = _put(oh, ol, k - 1 - p, 3 - _at(hi, lo, p))
    return oh, ol


def _reduce(hi, lo, covg, edges):
    """Sum the coverage and OR the edge bits of equal keys; returns
    (hi, lo, covg, edges) of the unique keys, ascending."""
    o = order(hi, lo)
    hi, lo, covg, edges = hi[o], lo[o], covg[o], edges[o]
    new = torch.ones(len(hi), dtype=torch.bool, device=hi.device)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    inv = torch.cumsum(new.to(torch.int64), 0) - 1
    n = int(new.sum())
    c = torch.zeros(n, dtype=torch.int64, device=hi.device)
    c.index_add_(0, inv, covg)
    e = torch.zeros(n, dtype=torch.int64, device=hi.device)
    for b in range(8):
        bit = torch.zeros(n, dtype=torch.int64, device=hi.device)
        bit.scatter_reduce_(0, inv, (edges >> b) & 1, "amax")
        e |= bit << b
    return hi[new], lo[new], c, e


def build(reads: np.ndarray, k: int, device) -> tuple:
    """(keys (n, 2) [hi, lo], covg, edges) int64 tensors on `device`,
    keys ascending, of the graph of reads (n, L) uint8 codes 0..3."""
    parts = []
    for s in range(0, len(reads), BLOCK):
        r = torch.from_numpy(np.ascontiguousarray(reads[s:s + BLOCK])).to(
            device, torch.int64)
        hi, lo, orient = kmers_of(r, k)
        # kmer i: the base after it, read along the read; kmer i+1: the
        # complement of the base before it, read against the read
        out_bit = torch.zeros_like(hi)
        out_bit[:, :-1] = 1 << (r[:, k:] + 4 * orient[:, :-1])
        in_bit = torch.zeros_like(hi)
        in_bit[:, 1:] = 1 << ((3 - r[:, :-k]) + 4 * (1 - orient[:, 1:]))
        parts.append(_reduce(hi.reshape(-1), lo.reshape(-1),
                             torch.ones_like(hi).reshape(-1),
                             (out_bit | in_bit).reshape(-1)))
        del r, hi, lo, orient, out_bit, in_bit
    if not parts:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return torch.zeros((0, 2), dtype=torch.int64, device=device), z, z
    hi, lo, c, e = parts[0] if len(parts) == 1 else _reduce(
        *(torch.cat(x) for x in zip(*parts)))
    return torch.stack([hi, lo], dim=1), c, e


def find(keys: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor):
    """(row, found) of each query key (qhi, qlo) in ascending keys (N, 2):
    a binary search for lo within the rows of equal hi."""
    N = len(keys)
    if N == 0:
        return (torch.zeros_like(qhi), torch.zeros(qhi.shape, dtype=torch.bool,
                                                   device=qhi.device))
    hi, qhi = keys[:, 0].contiguous(), qhi.contiguous()
    lo = keys[:, 1] ^ SIGN
    a = torch.searchsorted(hi, qhi)
    b = torch.searchsorted(hi, qhi, right=True)
    q = qlo ^ SIGN
    while bool((a < b).any()):
        mid = (a + b) // 2
        go = lo[mid.clamp(max=N - 1)] < q
        open_ = a < b
        a = torch.where(open_ & go, mid + 1, a)
        b = torch.where(open_ & ~go, mid, b)
    j = a.clamp(max=N - 1)
    return j, (keys[j, 0] == qhi) & (keys[j, 1] == qlo)


def _shl(hi, lo, k: int, n):
    """The kmer after (hi, lo) when base n follows."""
    nhi = (hi << 2) | ((lo >> 62) & 3)
    nlo = (lo << 2) | n
    if k > 32:
        return nhi & ((1 << (2 * k - 64)) - 1), nlo
    if k < 32:
        nlo = nlo & ((1 << (2 * k)) - 1)
    return torch.zeros_like(hi), nlo


def _shr(hi, lo, k: int, n):
    """The kmer before (hi, lo) when base n precedes it."""
    nlo = ((lo >> 2) & LOW62) | ((hi & 3) << 62)
    return _put(hi >> 2, nlo, k - 1, n)


def neighbours(keys: torch.Tensor, edges: torch.Tensor, k: int):
    """dbg.neighbours for two-word keys: (N, 8) int64, the vertex reached
    from vertex 2r + o by base n at column 4o + n, where that edge is set
    and the kmer is in the graph, else -1."""
    N = len(keys)
    out = torch.full((N, 8), -1, dtype=torch.int64, device=keys.device)
    if N == 0:
        return out
    hi, lo = keys[:, 0], keys[:, 1]
    rh, rl = revcomp(hi, lo, k)
    for o, (oh, ol), (ch, cl) in ((0, (hi, lo), (rh, rl)),
                                  (1, (rh, rl), (hi, lo))):
        for n in range(4):
            xh, xl = _shl(oh, ol, k, n)
            yh, yl = _shr(ch, cl, k, 3 - n)
            rc_less = lt(yh, yl, xh, xl)
            j, ok = find(keys, torch.where(rc_less, yh, xh),
                         torch.where(rc_less, yl, xl))
            ok &= ((edges >> (4 * o + n)) & 1) == 1
            out[:, 4 * o + n] = torch.where(ok, 2 * j + rc_less.to(
                torch.int64), -1)
    return out


def clean(keys, covg, edges, k: int) -> tuple:
    """clean -T -U of a graph: (keys, covg, edges) of what it keeps
    (dbg.clean with two-word keys)."""
    thr = dbg.pick_threshold(dbg.covg_histogram(covg))
    if thr < 0:
        raise ValueError("no automatic cleaning threshold")
    nbr = neighbours(keys, edges, k)
    u = dbg.unitig_labels(keys, edges, k, nbr)
    N = len(keys)
    # median coverage of each unitig: sort by (unitig, coverage)
    o = torch.argsort(u["uid"] * (1 << 32) + covg)
    s_uid, s_cov = u["uid"][o], covg[o]
    start = torch.searchsorted(s_uid, u["uid"])
    ln = u["length"]
    lo = (start + (ln - 1) // 2).clamp(max=N - 1)
    hi = (start + ln // 2).clamp(max=N - 1)
    median = (s_cov[lo] + s_cov[hi]) // 2
    ends_out = dbg.outdegree(edges, u["e0"]) + dbg.outdegree(edges, u["e1"])
    tip = ~u["cyc"] & (ends_out <= 1)
    keep = ~((median < thr) | (tip & (ln < 2 * k)))
    # clear the edges into what goes (or into no kmer at all)
    kept_nbr = (nbr >= 0) & keep[(nbr.clamp(min=0) >> 1)]
    bits = 1 << torch.arange(8, device=keys.device)
    lost = ((edges[:, None] & bits) != 0) & ~kept_nbr
    new_edges = edges & ~(lost.to(torch.int64) * bits).sum(dim=1)
    return keys[keep], covg[keep], new_edges[keep]


def kmer_strings(keys, k: int) -> list:
    """The kmer strings of (n, 2) int64 keys (numpy or torch)."""
    x = np.asarray(torch.as_tensor(keys).cpu().numpy(), np.int64)
    if len(x) == 0:
        return []
    pos = np.arange(k - 1, -1, -1)
    word = np.where(pos < 32, 1, 0)
    shift = 2 * np.where(pos < 32, pos, pos - 32)
    codes = ((x[:, word] >> shift[None, :]) & 3).astype(np.uint8)
    chars = np.frombuffer(b"ACGT", np.uint8)[codes]
    return [bytes(row).decode() for row in chars]


def unitigs(keys, edges, k: int) -> list:
    """The unitigs' strings (dbg.unitigs with two-word keys).  A cycle
    starts at its least key, read as stored; a linear unitig is given in
    either direction."""
    N = len(keys)
    if N == 0:
        return []
    u = dbg.unitig_labels(keys, edges, k, neighbours(keys, edges, k))
    r = torch.arange(N, dtype=torch.int64, device=keys.device)
    rh, rl = revcomp(keys[:, 0], keys[:, 1], k)
    rc = torch.stack([rh, rl], dim=1)
    chain = ~u["cyc"]
    # a linear unitig read towards its greater end vertex: along
    # orientation 0 of a kmer if walking that way reaches it
    far = torch.maximum(u["e0"], u["e1"])
    along = (u["e0"] != far).to(torch.int64)
    pos = torch.where(along == 0, u["d1"], u["d0"])
    rows = r[chain]
    rows = rows[torch.argsort(u["uid"][rows] * (1 << 32) + pos[rows])]
    okm = torch.where(along[rows, None] == 1, rc[rows], keys[rows])
    uid = u["uid"][rows].cpu().numpy()
    okm_h = okm.cpu().numpy()
    last = np.frombuffer(b"ACGT", np.uint8)[(okm_h[:, 1] & 3).astype(
        np.int64)]
    firsts = np.nonzero(np.concatenate([[len(uid) > 0],
                                        uid[1:] != uid[:-1]]))[0]
    heads = kmer_strings(okm_h[firsts], k)
    bounds = np.append(firsts, len(uid))
    out = [h + last[s + 1:e].tobytes().decode()
           for h, s, e in zip(heads, bounds[:-1], bounds[1:])]
    # cycles (few): walk each from its least kmer
    cyc_rows = r[u["cyc"]].cpu().numpy()
    if len(cyc_rows):
        succ = u["succ"].cpu().numpy()
        cuid = u["uid"].cpu().numpy()
        last_fw = (keys[:, 1] & 3).cpu().numpy()
        last_rc = (rl & 3).cpu().numpy()
        keys_h = keys.cpu().numpy()
        done = set()
        for row in cyc_rows.tolist():        # ascending: least key first
            if cuid[row] in done:
                continue
            done.add(cuid[row])
            seq = [kmer_strings(keys_h[row:row + 1], k)[0]]
            v = int(succ[2 * row])
            while v >= 0 and (v >> 1) != row:
                code = last_fw[v >> 1] if v & 1 == 0 else last_rc[v >> 1]
                seq.append("ACGT"[int(code)])
                v = int(succ[v])
            out.append("".join(seq))
    return out


def records(keys, covg, edges, k: int) -> tuple:
    """A graph of one colour from torch (keys (n, 2), covg, edges) in the
    form compare.read_ctx gives: keys (n, W) uint64 with W = nwords(k)."""
    kh = keys.cpu().numpy().astype(np.uint64)
    return (np.ascontiguousarray(kh[:, 2 - nwords(k):]),
            covg.cpu().numpy().astype(np.uint32)[:, None],
            edges.cpu().numpy().astype(np.uint8)[:, None])

"""A plain de Bruijn graph of one colour, worked out from McCortex's
definitions with torch alone (on the card or the CPU); it shares no code
with the program.

A kmer (k <= 32) is an int64 of 2-bit codes (A, C, G, T = 0..3), its
first base in the highest bits.  Its key is the lesser of the kmer and
its reverse complement.  A vertex is 2 * row + orientation: orientation
0 reads the key as stored, 1 its reverse complement.  An edge byte has
bit (base + 4 * orientation) set when, reading the key in that
orientation, `base` follows; so the high nibble holds the complements
of the bases that precede the key.

- build: every occurrence of a kmer in a read adds 1 to its coverage;
  each pair of neighbouring kmers in a read sets one edge bit on each;
- clean -T -U: unitigs whose median coverage is under the automatic
  threshold, and tips of fewer than 2k kmers, go in one pass; edges to
  removed kmers are cleared;
- unitigs: maximal paths whose inner links are each the only way out of
  one kmer and the only way into the next; a unitig is broken at a
  kmer that would follow itself (self-loop, hairpin).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 1 << 17          # reads a block in build
HIST_BINS = 1000         # coverage histogram of the threshold: 0..999+


def _mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def kmers_of(reads: torch.Tensor, k: int):
    """(keys, orients) of every window of reads (B, L) int64 codes: each
    (B, L - k + 1)."""
    P = reads.shape[1] - k + 1
    fw = torch.zeros((reads.shape[0], P), dtype=torch.int64,
                     device=reads.device)
    rc = torch.zeros_like(fw)
    for j in range(k):
        col = reads[:, j:j + P]
        fw |= col << (2 * (k - 1 - j))
        rc |= (3 - col) << (2 * j)
    return torch.minimum(fw, rc), (fw > rc).to(torch.int64)


def revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for j in range(k):
        out |= (3 - ((x >> (2 * j)) & 3)) << (2 * (k - 1 - j))
    return out


def _reduce(keys, covg, edges):
    """Sum the coverage and OR the edge bits of equal keys; keys sorted."""
    ukeys, inv = torch.unique(keys, sorted=True, return_inverse=True)
    n = len(ukeys)
    c = torch.zeros(n, dtype=torch.int64, device=keys.device)
    c.index_add_(0, inv, covg)
    e = torch.zeros(n, dtype=torch.int64, device=keys.device)
    for b in range(8):
        bit = torch.zeros(n, dtype=torch.int64, device=keys.device)
        bit.scatter_reduce_(0, inv, (edges >> b) & 1, "amax")
        e |= bit << b
    return ukeys, c, e


def build(reads: np.ndarray, k: int, device) -> tuple:
    """(keys, covg, edges) int64 tensors on `device`, keys ascending, of
    the graph of reads (n, L) uint8 codes 0..3."""
    parts = []
    for s in range(0, len(reads), BLOCK):
        r = torch.from_numpy(np.ascontiguousarray(reads[s:s + BLOCK])).to(
            device, torch.int64)
        keys, orient = kmers_of(r, k)
        # kmer i: the base after it, read along the read; kmer i+1: the
        # complement of the base before it, read against the read
        out_bit = torch.zeros_like(keys)
        out_bit[:, :-1] = 1 << (r[:, k:] + 4 * orient[:, :-1])
        in_bit = torch.zeros_like(keys)
        in_bit[:, 1:] = 1 << ((3 - r[:, :-k]) + 4 * (1 - orient[:, 1:]))
        parts.append(_reduce(keys.reshape(-1), torch.ones_like(
            keys).reshape(-1), (out_bit | in_bit).reshape(-1)))
        del r, keys, orient, out_bit, in_bit
    if len(parts) == 1:
        return parts[0]
    return _reduce(*(torch.cat(x) for x in zip(*parts)))


def _popcount4(x: torch.Tensor) -> torch.Tensor:
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def neighbours(keys: torch.Tensor, edges: torch.Tensor, k: int):
    """(N, 8) int64: the vertex reached from vertex 2r + o by base n at
    column 4o + n, where that edge is set and the kmer is in the graph,
    else -1."""
    N = len(keys)
    out = torch.full((N, 8), -1, dtype=torch.int64, device=keys.device)
    if N == 0:
        return out
    rc = revcomp(keys, k)
    for o, okm in ((0, keys), (1, rc)):
        for n in range(4):
            nxt = ((okm << 2) | n) & _mask(k)
            nrc = (((rc if o == 0 else keys) >> 2)
                   | ((3 - n) << (2 * (k - 1))))
            key = torch.minimum(nxt, nrc)
            j = torch.searchsorted(keys, key).clamp(max=N - 1)
            ok = (keys[j] == key) & (((edges >> (4 * o + n)) & 1) == 1)
            out[:, 4 * o + n] = torch.where(ok, 2 * j + (nxt > nrc), -1)
    return out


def outdegree(edges: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Edges out of vertices v."""
    return _popcount4((edges[v >> 1] >> (4 * (v & 1))) & 15)


def unitig_labels(keys: torch.Tensor, edges: torch.Tensor, k: int,
                  nbr: torch.Tensor | None = None) -> dict:
    """Per kmer: its unitig's id, length in kmers, whether it is a cycle,
    and the unitig's two end vertices (walking from the kmer in either
    orientation), with the steps to each."""
    N = len(keys)
    dev = keys.device
    nbr = neighbours(keys, edges, k) if nbr is None else nbr
    v = torch.arange(2 * N, dtype=torch.int64, device=dev)
    nib = (edges[v >> 1] >> (4 * (v & 1))) & 15
    single = _popcount4(nib) == 1
    base = torch.where(nib == 1, 0, torch.where(nib == 2, 1,
                       torch.where(nib == 4, 2, 3)))
    w = nbr.reshape(-1)[4 * v + base]
    wc = w.clamp(min=0)
    ok = single & (w >= 0) & (outdegree(edges, wc ^ 1) == 1) & \
        ((wc >> 1) != (v >> 1))
    succ = torch.where(ok, w, -1)
    # pointer jumping: after t rounds jump[v] is 2**t steps on (or the
    # end), dist the steps taken, low the least vertex passed
    jump = torch.where(succ < 0, v, succ)
    dist = (succ >= 0).to(torch.int64)
    low = torch.minimum(v, jump)
    for _ in range(max(1, math.ceil(math.log2(max(2 * N, 2)))) + 1):
        dist = dist + dist[jump]
        low = torch.minimum(low, low[jump])
        jump = jump[jump]
    r = torch.arange(N, dtype=torch.int64, device=dev)
    e0, e1 = jump[2 * r], jump[2 * r + 1]
    cyc = succ[e0] >= 0
    uid = torch.where(cyc, torch.minimum(low[2 * r], low[2 * r + 1]),
                      torch.minimum(e0, e1))
    size = torch.bincount(uid, minlength=2 * N)[uid]
    length = torch.where(cyc, size, dist[2 * r] + dist[2 * r + 1] + 1)
    return dict(succ=succ, uid=uid, length=length, cyc=cyc, e0=e0, e1=e1,
                d0=dist[2 * r], d1=dist[2 * r + 1])


def covg_histogram(covg: torch.Tensor) -> np.ndarray:
    return torch.bincount(covg.clamp(0, HIST_BINS - 1),
                          minlength=HIST_BINS).cpu().numpy()


def pick_threshold(hist: np.ndarray) -> int:
    """McCortex's automatic cleaning threshold from the histogram of kmer
    coverage (bins 0..len-1), or -1 where none is found.  The error kmers
    are modelled as Poisson counts with a Gamma-distributed mean; the
    shape alpha is fitted to the ratios of the counts at coverage 1, 2
    and 3, the rate beta from alpha and the first ratio.  The threshold
    is the first coverage at which the expected error kmers are at most
    0.1 % of the kmers seen there; failing that, the first at which the
    false positive share drops below the false negative share; failing
    that, the first at which the real kmers cut exceed the errors left.
    It is refused where it would keep under 20 % of the coverage."""
    h = [float(x) for x in hist]
    n = len(h)
    if h[1] == 0 or h[2] == 0 or h[3] == 0:
        return -1
    r1, r2 = h[2] / h[1], h[3] / h[2]
    target = r2 / r1
    alpha, best = None, None
    for i in range(1, 201):
        a = i * 0.01
        f = math.gamma(a) * math.gamma(a + 2) / (2 * math.gamma(a + 1) ** 2)
        if best is None or abs(f - target) < best:
            alpha, best = a, abs(f - target)
    beta = max(math.gamma(alpha + 1) / (r1 * math.gamma(alpha)) - 1.0, 1.0)
    c0 = h[1] * (beta / (1 + beta)) ** (-alpha)
    err = [0.0] * n
    for i in range(1, n):
        lg = (alpha * math.log(beta) - math.lgamma(alpha) - math.lgamma(i)
              + math.lgamma(max(alpha + i - 1, 1e-12))
              - (alpha + i - 1) * math.log1p(beta))
        err[i] = math.exp(lg) * c0
    e_total, d_total = sum(err[1:]), sum(h[1:])
    cut = next((i for i in range(1, n) if h[i] > 0 and err[i] / h[i] <= 0.001),
               -1)
    if cut < 0:
        e_sum = d_sum = 0.0
        e_rem, d_rem = e_total, d_total
        for i in range(1, n):
            e_sum += err[i]
            d_sum += h[i]
            e_rem -= err[i]
            d_rem -= h[i]
            if d_sum > 0 and d_rem > 0 and 1 - e_sum / d_sum > e_rem / d_rem:
                cut = i
                break
    if cut < 0:
        e_sum = d_sum = 0.0
        e_rem = e_total
        for i in range(1, n):
            e_sum += err[i]
            d_sum += h[i]
            e_rem -= err[i]
            if d_sum - e_sum > e_rem:
                cut = i
                break
    if cut < 0:
        return -1
    below = sum(h[i] * i for i in range(cut))
    above = sum(h[i] * i for i in range(cut, n))
    if below + above > 0 and above / (below + above) < 0.2:
        return -1
    return cut


def clean(keys, covg, edges, k: int) -> tuple:
    """clean -T -U of a graph: (keys, covg, edges) of what it keeps."""
    thr = pick_threshold(covg_histogram(covg))
    if thr < 0:
        raise ValueError("no automatic cleaning threshold")
    nbr = neighbours(keys, edges, k)
    u = unitig_labels(keys, edges, k, nbr)
    N = len(keys)
    # median coverage of each unitig: sort by (unitig, coverage)
    order = torch.argsort(u["uid"] * (1 << 32) + covg)
    s_uid, s_cov = u["uid"][order], covg[order]
    start = torch.searchsorted(s_uid, u["uid"])
    ln = u["length"]
    lo = (start + (ln - 1) // 2).clamp(max=N - 1)
    hi = (start + ln // 2).clamp(max=N - 1)
    median = (s_cov[lo] + s_cov[hi]) // 2
    ends_out = outdegree(edges, u["e0"]) + outdegree(edges, u["e1"])
    tip = ~u["cyc"] & (ends_out <= 1)
    keep = ~((median < thr) | (tip & (ln < 2 * k)))
    # clear the edges into what goes (or into no kmer at all)
    kept_nbr = (nbr >= 0) & keep[(nbr.clamp(min=0) >> 1)]
    bits = 1 << torch.arange(8, device=keys.device)
    lost = ((edges[:, None] & bits) != 0) & ~kept_nbr
    new_edges = edges & ~(lost.to(torch.int64) * bits).sum(dim=1)
    return keys[keep], covg[keep], new_edges[keep]


def kmer_strings(keys, k: int) -> list:
    """The kmer strings of int64 keys (numpy or torch)."""
    x = np.asarray(torch.as_tensor(keys).cpu().numpy(), np.int64)
    if len(x) == 0:
        return []
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.int64)
    codes = ((x[:, None] >> shifts[None, :]) & 3).astype(np.uint8)
    chars = np.frombuffer(b"ACGT", np.uint8)[codes]
    return [bytes(row).decode() for row in chars]


def unitigs(keys, edges, k: int) -> list:
    """The unitigs' strings.  A cycle starts at its least key, read as
    stored; a linear unitig is given in either direction."""
    N = len(keys)
    if N == 0:
        return []
    u = unitig_labels(keys, edges, k)
    r = torch.arange(N, dtype=torch.int64, device=keys.device)
    chain = ~u["cyc"]
    # a linear unitig read towards its greater end vertex: along
    # orientation 0 of a kmer if walking that way reaches it
    far = torch.maximum(u["e0"], u["e1"])
    along = (u["e0"] != far).to(torch.int64)
    pos = torch.where(along == 0, u["d1"], u["d0"])
    rows = r[chain]
    order = torch.argsort(u["uid"][rows] * (1 << 32) + pos[rows])
    rows = rows[order]
    okm = torch.where(along[rows] == 1, revcomp(keys[rows], k), keys[rows])
    uid = u["uid"][rows].cpu().numpy()
    okm_h = okm.cpu().numpy()
    last = np.frombuffer(b"ACGT", np.uint8)[(okm_h & 3).astype(np.int64)]
    firsts = np.nonzero(np.concatenate([[True], uid[1:] != uid[:-1]]))[0]
    heads = kmer_strings(okm_h[firsts], k)
    bounds = np.append(firsts, len(uid))
    out = [h + last[s + 1:e].tobytes().decode()
           for h, s, e in zip(heads, bounds[:-1], bounds[1:])]
    # cycles (few): walk each from its least kmer
    cyc_rows = r[u["cyc"]].cpu().numpy()
    if len(cyc_rows):
        succ = u["succ"].cpu().numpy()
        cuid = u["uid"].cpu().numpy()
        keys_h = keys.cpu().numpy()
        rc_h = revcomp(keys, k).cpu().numpy()
        done = set()
        for row in cyc_rows.tolist():        # ascending: least key first
            if cuid[row] in done:
                continue
            done.add(cuid[row])
            seq = [kmer_strings(keys_h[row:row + 1], k)[0]]
            v = int(succ[2 * row])
            while v >= 0 and (v >> 1) != row:
                kk = keys_h[v >> 1] if v & 1 == 0 else rc_h[v >> 1]
                seq.append("ACGT"[int(kk) & 3])
                v = int(succ[v])
            out.append("".join(seq))
    return out

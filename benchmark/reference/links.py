"""Link threading (`thread`, one colour, no earlier links) worked out from
McCortex's definitions, read by read, in numpy and plain Python; it
shares no code with the program.

A read is mapped to the vertices of its kmers (dbg.py's conventions);
a kmer that is not in the graph leaves a hole.  With gap filling each
hole between two aligned stretches is bridged through the graph (one
way, end check on):

- a hole of n kmers accepts a bridge of lo..hi kmers, hi = n + w and
  lo = max(0, n - w), w = int(0.1 n + 5);
- first forwards from the kmer before the hole: the walk takes each
  kmer's only edge out and stops where there is none or more than one
  (with no links nothing decides a fork); the bridge is the kmers
  passed before the walk first reaches the kmer after the hole, within
  hi + 1 steps; then, failing that, backwards from the kmer after the
  hole to the kmer before it;
- a bridge shorter than lo is refused, and so is one whose walk, going
  on past the far anchor, leaves the read's aligned kmers there before
  it stops (the end check);
- a hole that is not bridged stays a hole.

Links come from each unbroken stretch of the bridged path.  A forward
fork is a kmer with more than one edge out whose successor is in the
stretch, its junction the successor's last base; a reverse fork one with
more than one edge in whose predecessor is in the stretch, its junction
the complement of the predecessor's first base.  For each reverse fork
at p, in order, while a forward fork lies at p or later: a link at the
kmer before p, read along the read, holding the forward junctions from
p - 1 on.  For each forward fork at q, from the last, while a reverse
fork lies at q or earlier: a link at the kmer after q, read against the
read, holding the reverse junctions from q + 1 back, last first.  Equal
links at one kmer are counted.  Each read with an aligned kmer adds its
bridged path's length in bases to the contig histogram (without gap
filling: each aligned stretch of the read).
"""

from __future__ import annotations

import collections

import numpy as np

from benchmark.reference.dbg import kmer_strings

GAP_VARIANCE = 0.1
GAP_WIGGLE = 5
_ACGT = "ACGT"


def _revcomp(x: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(x)
    for j in range(k):
        out |= (3 - ((x >> (2 * j)) & 3)) << (2 * (k - 1 - j))
    return out


class Graph:
    """A graph of one colour on the host: keys (ascending) and edge
    bytes, with for each vertex its only successor (-1 where it has no
    edge out or more than one), its degrees and its end bases."""

    def __init__(self, keys, edges, k: int):
        self.k = k
        self.keys = np.asarray(keys, np.int64)
        edges = np.asarray(edges, np.int64)
        rc = _revcomp(self.keys, k)
        okm = np.stack([self.keys, rc], axis=1).reshape(-1)      # by vertex
        nib = (np.repeat(edges, 2) >> (4 * np.tile([0, 1], len(edges)))) & 15
        deg = np.array([bin(i).count("1") for i in range(16)])[nib]
        base = np.array([0, 0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0])[nib]
        nxt = ((okm << 2) | base) & ((1 << (2 * k)) - 1)
        okm_rc = np.stack([rc, self.keys], axis=1).reshape(-1)
        nrc = (okm_rc >> 2) | ((3 - base) << (2 * (k - 1)))
        row = self.lookup(np.minimum(nxt, nrc))
        succ = np.where((deg == 1) & (row >= 0), 2 * row + (nxt > nrc), -1)
        self.succ = succ.tolist()
        self.outdeg = deg.tolist()
        self.last = (okm & 3).tolist()
        self.first = (okm >> (2 * (k - 1))).tolist()

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows of canonical keys, -1 where absent."""
        if len(self.keys) == 0:
            return np.full(keys.shape, -1, np.int64)
        j = np.minimum(np.searchsorted(self.keys, keys), len(self.keys) - 1)
        return np.where(self.keys[j] == keys, j, -1)

    def vertices(self, reads: np.ndarray) -> np.ndarray:
        """(B, L - k + 1) vertex of each window of reads, -1 where the
        kmer is absent or the window holds a code that is no base."""
        k = self.k
        r = reads.astype(np.int64)
        P = r.shape[1] - k + 1
        fw = np.zeros((r.shape[0], P), np.int64)
        rc = np.zeros_like(fw)
        bad = np.zeros(fw.shape, bool)
        for j in range(k):
            col = r[:, j:j + P]
            bad |= col > 3
            col = col & 3
            fw |= col << (2 * (k - 1 - j))
            rc |= (3 - col) << (2 * j)
        row = self.lookup(np.minimum(fw, rc))
        return np.where((row >= 0) & ~bad, 2 * row + (fw > rc), -1)

    def walk(self, v: int, steps: int) -> list:
        out = []
        succ = self.succ
        for _ in range(steps):
            v = succ[v]
            if v < 0:
                break
            out.append(v)
        return out

    def agrees(self, v: int, expected) -> bool:
        """Whether a walk from v, until it stops, passes the expected
        vertices in turn."""
        succ = self.succ
        for x in expected:
            v = succ[v]
            if v < 0:
                return True
            if v != x:
                return False
        return True


def _runs(path) -> list:
    """(start, end) of each stretch of path without a hole, inclusive."""
    runs, s = [], None
    for i, v in enumerate(path):
        if v >= 0 and s is None:
            s = i
        elif v < 0 and s is not None:
            runs.append((s, i - 1))
            s = None
    if s is not None:
        runs.append((s, len(path) - 1))
    return runs


def bridge(g: Graph, path, left, right):
    """The vertices that fill the hole between aligned stretches `left`
    and `right` of a read's path, or None."""
    l, r = left[1], right[0]
    n = r - l - 1
    w = int(n * GAP_VARIANCE + GAP_WIGGLE)
    lo, hi = max(0, n - w), n + w
    la, ra = path[l], path[r]
    fw = g.walk(la, hi + 1)
    if ra in fw:
        d = fw.index(ra)
        if d >= lo and g.agrees(ra, path[r + 1:right[1] + 1]):
            return fw[:d]
    bw = g.walk(ra ^ 1, hi + 1)
    if la ^ 1 in bw:
        d = bw.index(la ^ 1)
        if d >= lo and g.agrees(la ^ 1, [x ^ 1 for x in
                                         path[left[0]:l][::-1]]):
            return [x ^ 1 for x in bw[:d][::-1]]
    return None


def links_of_stretch(g: Graph, vs, out: collections.Counter) -> None:
    """Count the links of one unbroken stretch of vertices into `out`,
    keyed (row, orientation, junction bases)."""
    m = len(vs)
    fwd = [(i, g.last[vs[i + 1]]) for i in range(m - 1)
           if g.outdeg[vs[i]] > 1]
    rev = [(i, 3 - g.first[vs[i - 1]]) for i in range(1, m)
           if g.outdeg[vs[i] ^ 1] > 1]
    if not fwd or not rev:
        return
    for p, _ in rev:
        if fwd[-1][0] < p:
            break
        v = vs[p - 1]
        out[(v >> 1, v & 1, tuple(b for q, b in fwd if q >= p - 1))] += 1
    for q, _ in reversed(fwd):
        if rev[0][0] > q:
            break
        v = vs[q + 1]
        out[(v >> 1, 1 - (v & 1),
             tuple(b for p, b in reversed(rev) if p <= q + 1))] += 1


def thread(g: Graph, reads: np.ndarray, gap_fill: bool = True) -> tuple:
    """(links Counter keyed (row, orientation, junctions), contig
    histogram {length in bases: reads}) of threading reads (B, L)."""
    k = g.k
    links = collections.Counter()
    hist = collections.Counter()
    for path in g.vertices(reads).tolist():
        runs = _runs(path)
        if not runs:
            continue
        if gap_fill:
            full = list(path[runs[0][0]:runs[0][1] + 1])
            for left, right in zip(runs, runs[1:]):
                fill = bridge(g, path, left, right)
                full += ([-1] * (right[0] - left[1] - 1) if fill is None
                         else fill)
                full += path[right[0]:right[1] + 1]
            hist[len(full) + k - 1] += 1
            stretches = [full[s:e + 1] for s, e in _runs(full)]
        else:
            stretches = [path[s:e + 1] for s, e in runs]
            for s in stretches:
                hist[len(s) + k - 1] += 1
        for s in stretches:
            links_of_stretch(g, s, links)
    return links, dict(hist)


def records(g: Graph, links: collections.Counter) -> collections.Counter:
    """The links as compare.read_ctp gives a .ctp's records: (kmer, F|R,
    junctions, counts, bases), one each."""
    rows = sorted({r for r, _, _ in links})
    names = dict(zip(rows, kmer_strings(g.keys[rows], g.k)))
    return collections.Counter(
        (names[r], "FR"[o], str(len(j)), str(c), "".join(_ACGT[b] for b in j))
        for (r, o, j), c in links.items())

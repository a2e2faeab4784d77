"""The plain reference against a third, string-level working of
McCortex's definitions on small random graphs: kmers, counts and edges
of build; unitigs that partition the graph; links of a hand-made
stretch."""

import collections

import numpy as np
import pytest
import torch

from benchmark.reference import dbg
from benchmark.reference import links as rlinks

_COMP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _strings(reads) -> list:
    return ["".join("ACGT"[b] for b in r) for r in reads]


@pytest.mark.parametrize("k", [5, 9, 31])
def test_build_matches_string_counts_and_edges(k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 300, dtype=np.uint8)
    starts = rng.integers(0, 300 - 60, 80)
    reads = np.stack([genome[s:s + 60] for s in starts])
    covg = collections.Counter()
    edges = collections.defaultdict(int)
    for s in _strings(reads):
        for i in range(len(s) - k + 1):
            km = s[i:i + k]
            key = min(km, _rc(km))
            covg[key] += 1
            o = int(km != key)
            if i + k < len(s):
                edges[key] |= 1 << ("ACGT".index(s[i + k]) + 4 * o)
            if i > 0:
                edges[key] |= 1 << ("ACGT".index(s[i - 1].translate(_COMP))
                                    + 4 * (1 - o))
    keys, c, e = dbg.build(reads, k, "cpu")
    names = dbg.kmer_strings(keys, k)
    assert names == sorted(covg)
    assert c.tolist() == [covg[n] for n in names]
    assert e.tolist() == [edges[n] for n in names]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_unitigs_partition_the_graph(seed):
    k = 7
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 400, dtype=np.uint8)
    reads = np.stack([genome[s:s + 40] for s in rng.integers(0, 360, 120)])
    keys, _, edges = dbg.build(reads, k, "cpu")
    seen = collections.Counter()
    for u in dbg.unitigs(keys, edges, k):
        for i in range(len(u) - k + 1):
            seen[min(u[i:i + k], _rc(u[i:i + k]))] += 1
    names = dbg.kmer_strings(keys, k)
    assert sorted(seen) == names and set(seen.values()) == {1}


def test_links_of_a_stretch():
    """A read through a small graph with forks, its links worked out by
    hand.  At k = 5 the read's forward forks (more than one edge out)
    are at kmers 2, 4 and 12, its reverse forks (more than one edge in)
    at 3 and 8.  Reverse fork 3 puts a link at kmer 2 (GTTGC, stored as
    GCAAC, so R) with the forward choices from 2 on: A, G, G; reverse
    fork 8 one at kmer 7 (AAGGC, F) with those from 7 on: G.  Forward
    fork 12 puts one at kmer 13 (TACCG, stored as CGGTA, read against
    the read: F) with the complemented reverse choices from 13 back:
    T, C; forward fork 4 one at kmer 5 (GCAAG, stored as CTTGC: F)
    with C; forward fork 2 has no reverse fork at or before it."""
    k = 5
    a = "ACGTTGCAAGGCTTACCGATG"
    b = "ACGTTGCTAGGCTTACCAATG"
    reads = np.array([[("ACGT".index(c)) for c in s] for s in (a, b)],
                     np.uint8)
    keys, _, edges = dbg.build(reads, k, "cpu")
    g = rlinks.Graph(keys.numpy(), edges.numpy(), k)
    links, hist = rlinks.thread(g, reads[:1], gap_fill=False)
    assert hist == {len(a): 1}
    assert rlinks.records(g, links) == collections.Counter([
        ("GCAAC", "R", "3", "1", "AGG"), ("AAGGC", "F", "1", "1", "G"),
        ("CGGTA", "F", "2", "1", "TC"), ("CTTGC", "F", "1", "1", "C")])
    assert torch.equal(keys, torch.sort(keys).values)

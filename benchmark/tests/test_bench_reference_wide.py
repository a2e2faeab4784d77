"""The two-word reference (dbg_wide.py) against a string-level working of
McCortex's definitions at k = 33, 61 and 63, where a kmer spans two
64-bit words; against dbg.py at k <= 31; `clean -T -U` on a circular
genome with a planted tip and a planted low-coverage unitig; a k=61
graph job on the CPU whose raw .ctx has one edge bit flipped failing
`raw_diff`; and the fork-filtered threading of checks/links_plain.py
against links.thread on every read of a small sample."""

import collections

import numpy as np
import pytest
import torch
from conftest import SEED

import mccortex_tpu_torch.io.ctx as ctxio
from benchmark.data import synth
from benchmark.harness import runner, spec
from benchmark.reference import compare, dbg, dbg_wide
from benchmark.reference import links as rlinks

_COMP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _codes(strings) -> np.ndarray:
    return np.stack([synth.codes_of(s) for s in strings])


def _string_graph(strings, k):
    """Counts and edge bytes of every canonical kmer of the strings."""
    covg = collections.Counter()
    edges = collections.defaultdict(int)
    for s in strings:
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
    return covg, edges


def _reads_with_palindrome(k, seed):
    """Random reads over a 300 bp genome that holds a palindrome of k + 1
    bases: its two kmers are each other's reverse complement, so one key
    has an edge to itself with the orientation flipped."""
    rng = np.random.default_rng(seed)
    half = synth.dna(rng.integers(0, 4, (k + 1) // 2, dtype=np.uint8))
    left = synth.dna(rng.integers(0, 4, 120, dtype=np.uint8))
    right = synth.dna(rng.integers(0, 4, 300 - 120 - k - 1, dtype=np.uint8))
    genome = left + half + _rc(half) + right
    starts = rng.integers(0, len(genome) - 100, 60).tolist() + [90]
    return [genome[s:s + 100] for s in starts]


@pytest.mark.parametrize("k", [33, 61, 63])
def test_build_matches_string_counts_and_edges(k):
    strings = _reads_with_palindrome(k, k)
    covg, edges = _string_graph(strings, k)
    keys, c, e = dbg_wide.build(_codes(strings), k, "cpu")
    names = dbg_wide.kmer_strings(keys, k)
    assert names == sorted(covg)
    assert c.tolist() == [covg[n] for n in names]
    assert e.tolist() == [edges[n] for n in names]
    # the palindrome's key: both of its windows, an edge to itself
    assert any(covg[n] >= 2 and (_rc(n)[:-1] == n[1:] or
                                 _rc(n)[1:] == n[:-1]) for n in names)


@pytest.mark.parametrize("k", [33, 61, 63])
def test_canonical_keys_and_words(k):
    """Each key is the lesser of a kmer and its reverse complement, held
    as (hi, lo): lo the last 32 bases, hi the rest; .ctx words in that
    order (records)."""
    strings = _reads_with_palindrome(k, k + 1)
    keys, c, e = dbg_wide.build(_codes(strings), k, "cpu")
    names = dbg_wide.kmer_strings(keys, k)
    for name, (hi, lo) in zip(names, keys.tolist()):
        assert name == min(name, _rc(name))
        n = int(name.translate(str.maketrans("ACGT", "0123")), 4)
        assert hi == n >> 64 and lo & (2 ** 64 - 1) == n & (2 ** 64 - 1)
    rh, rl = dbg_wide.revcomp(keys[:, 0], keys[:, 1], k)
    rc_names = dbg_wide.kmer_strings(torch.stack([rh, rl], 1), k)
    assert rc_names == [_rc(n) for n in names]
    words = dbg_wide.records(keys, c, e, k)[0]
    assert words.shape == (len(names), 2) and words.dtype == np.uint64
    assert [(int(a) << 64) | int(b) for a, b in words] == [
        int(n.translate(str.maketrans("ACGT", "0123")), 4) for n in names]


@pytest.mark.parametrize("k", [33, 61, 63])
def test_neighbours_across_the_word_boundary(k):
    """Every edge bit leads to the vertex of the string-level neighbour:
    the kmer after the key, read in the edge's orientation, shifted
    across the 32-base word boundary, its own key and orientation."""
    strings = _reads_with_palindrome(k, 2 * k)
    keys, _, edges = dbg_wide.build(_codes(strings), k, "cpu")
    names = dbg_wide.kmer_strings(keys, k)
    row = {n: i for i, n in enumerate(names)}
    nbr = dbg_wide.neighbours(keys, edges, k).tolist()
    n_edges = 0
    for r, name in enumerate(names):
        for o, s in ((0, name), (1, _rc(name))):
            for b in range(4):
                if not (int(edges[r]) >> (4 * o + b)) & 1:
                    assert nbr[r][4 * o + b] == -1
                    continue
                nxt = s[1:] + "ACGT"[b]
                key = min(nxt, _rc(nxt))
                assert nbr[r][4 * o + b] == 2 * row[key] + int(nxt != key)
                n_edges += 1
    assert n_edges > len(names)


def _circular_sample(k, seed, planted=True):
    """Reads of 50x at 0.3 % errors from a random circular 100 kb genome
    (no repeat at k >= 21), the genome's kmer strings, and the kmers of a
    planted tip (40 copies of a read with a substitution 10 bases from
    its end: a branch of 10 kmers that ends, at high coverage) and of a
    planted bubble (one read with a substitution in its middle: k kmers
    of coverage 1 joined to the genome at both ends).  Three more copies
    of a read with a substitution give the coverage fit the error kmers
    of coverage 3 that a genome without repeats lacks."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 100_000, dtype=np.uint8)
    ring = np.concatenate([g, g[:149]])
    reads, _ = synth.reads_of(ring, 50, rng, 150, 0.003)
    gs = synth.dna(ring)
    genome = {min(gs[i:i + k], _rc(gs[i:i + k])) for i in range(len(g))}
    if not planted:
        return reads, genome, set(), set()

    def variant(start, at):
        r = ring[start:start + 150].copy()
        r[at] = (r[at] + 1) % 4
        return r
    tip, bubble = variant(5_000, 140), variant(50_000, 75)

    def errors(r):
        s = synth.dna(r)
        return {min(s[i:i + k], _rc(s[i:i + k]))
                for i in range(151 - k)} - genome
    reads = np.concatenate([reads, np.stack(
        [tip] * 40 + [bubble] + [variant(80_000, 75)] * 3)])
    return reads, genome, errors(tip), errors(bubble)


def test_clean_removes_a_tip_and_a_low_coverage_unitig():
    k = 61
    reads, genome, tip, bubble = _circular_sample(k, 4)
    assert len(tip) == 10 and len(bubble) == k
    keys, covg, edges = dbg_wide.build(reads, k, "cpu")
    raw = dbg_wide.kmer_strings(keys, k)
    assert tip | bubble <= set(raw)
    assert dbg.pick_threshold(dbg.covg_histogram(covg)) > 1
    # the tip's coverage is above the threshold: only the tip rule takes it
    assert min(covg[[raw.index(t) for t in tip]].tolist()) >= 40
    ck, _, ce = dbg_wide.clean(keys, covg, edges, k)
    assert set(dbg_wide.kmer_strings(ck, k)) == genome
    # the cleaned graph is the circle: one unitig of every genome kmer
    (u,) = dbg_wide.unitigs(ck, ce, k)
    assert len(u) == len(genome) + k - 1


@pytest.mark.parametrize("k", [21, 31])
def test_equals_dbg_at_one_word(k):
    # a genome with repeat families, so the cleaned graph has linear
    # unitigs: dbg.unitigs reads no graph made of cycles alone
    _, reads, _ = synth.genome_and_reads(100_000, 50, 7)
    a, b = dbg.build(reads, k, "cpu"), dbg_wide.build(reads, k, "cpu")
    assert (b[0][:, 0] == 0).all()
    assert torch.equal(a[0], b[0][:, 1])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    ca, cb = dbg.clean(*a, k), dbg_wide.clean(*b, k)
    assert torch.equal(ca[0], cb[0][:, 1]) and torch.equal(ca[2], cb[2])
    assert compare.unitig_diff(dbg.unitigs(ca[0], ca[2], k),
                               dbg_wide.unitigs(cb[0], cb[2], k)) == 0
    assert compare.record_diff(compare.records(*a),
                               dbg_wide.records(*b, k)) == 0


def test_graph_wide_record_diff_counts_as_compare_does():
    k = 61
    reads, _, _, _ = _circular_sample(k, 9, planted=False)
    want = dbg_wide.build(reads[:3000], k, "cpu")
    rec = dbg_wide.records(*want, k)
    check = spec.check_module("graph_wide")
    assert check.record_diff(rec, want, "cpu") == 0
    keys, covg, edges = (x.copy() for x in rec)
    edges[7, 0] ^= 4                       # a record differs
    keys = np.concatenate([keys, keys[3:4]])     # a kmer held twice
    covg = np.concatenate([covg, covg[3:4]])
    edges = np.concatenate([edges, edges[3:4]])
    keys, covg, edges = keys[2:], covg[2:], edges[2:]    # two kmers lack
    order = np.random.default_rng(0).permutation(len(keys))
    got = (keys[order], covg[order], edges[order])
    # one differs, two lack, one held twice (counted as compare does:
    # once outside the kmers both hold and once as a repeat)
    assert check.record_diff(got, want, "cpu") == \
        compare.record_diff(got, rec) == 5


def test_fork_filtered_threading_equals_links_thread():
    k = 31
    _, reads, _ = synth.genome_and_reads(100_000, 50, 11)
    graph = dbg.clean(*dbg.build(reads, k, "cpu"), k)
    g = rlinks.Graph(graph[0].numpy(), graph[2].numpy(), k)
    reads = reads[:6000].copy()
    reads[5, 40] = 4                        # a code that is no base
    check = spec.check_module("links_plain")
    links, hist = check.thread_plain(g, reads, "cpu")
    want_links, want_hist = rlinks.thread(g, reads, gap_fill=False)
    assert links and links == want_links
    assert hist == want_hist


def _edge_flipped(monkeypatch):
    orig = ctxio.write_ctx

    def write_ctx(path, h, keys, covg, edges):
        edges = edges.copy()
        edges[len(edges) // 2] ^= 1
        return orig(path, h, keys, covg, edges)
    monkeypatch.setattr(ctxio, "write_ctx", write_ctx)


def test_flipped_edge_bit_fails_raw_diff(tiny_root, monkeypatch):
    _edge_flipped(monkeypatch)
    result, _ = runner.run_cell(tiny_root, "kpneu_k61.graph_wide", SEED,
                                0.1, False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["raw_diff"]["value"] > 0

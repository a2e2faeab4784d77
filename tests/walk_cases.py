"""Linked walks for holding the walk kernel (csrc/walk.cu) against the host
loop of links/walk.py, built with the port alone (torch and numpy, no jax):
tests/test_torch_kernels_gpu.py runs them on the card, and
scripts/cuda_emul/emulate.py runs the smaller ones through the kernel
compiled for the CPU.

A case is (graph, link store, start state, walk_linked keyword arguments).
Every walk is one the kernel takes: the adjacency given, no hop records,
confidence model, missing-information check or used-link marks.
"""

import dataclasses

import numpy as np
import torch

from mccortex_tpu_torch.align import correct as acorrect
from mccortex_tpu_torch.graph import adjacency as adjmod
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.graph import traverse as T
from mccortex_tpu_torch.links import store as lstore
from mccortex_tpu_torch.links import thread as lthread
from mccortex_tpu_torch.links import walk as lwalk


def _dna(n, rng):
    return rng.integers(0, 4, n).astype(np.uint8)


def _graph(seqs, k, device):
    """The graph of base-code rows of one length (4 = N)."""
    return tb.build([(np.stack(seqs), 0)], k, ncols=1, device=device)


def _reads(genome, n, length, err, rng):
    starts = rng.integers(0, len(genome) - length + 1, n)
    reads = genome[starts[:, None] + np.arange(length)].copy()
    hit = rng.random(reads.shape) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return reads


def diploid(k, device, gbp=4000, n_reads=480, rlen=100, seed=0):
    """A diploid region at 1 % read errors: two haplotypes of a random
    genome with a repeat unit three times over, SNPs 150 bp apart, every
    other one heterozygous.  Returns (graph of the haplotypes, reads)."""
    rng = np.random.default_rng(seed)
    unit = _dna(300, rng)
    hap = np.concatenate([_dna(gbp // 4, rng), unit, _dna(gbp // 4, rng),
                          unit, _dna(gbp // 4, rng), unit,
                          _dna(gbp // 4, rng)])
    hap2 = hap.copy()
    snps = np.arange(75, len(hap), 150)
    hap2[snps] = (hap2[snps] + 1) % 4
    hap[snps[::2]] = hap2[snps[::2]]
    reads = np.concatenate([_reads(h, n_reads // 2, rlen, 0.01, rng)
                            for h in (hap, hap2)])
    # the cleaned graph: the haplotypes' own kmers, so that a read error
    # is a gap to fill
    tiles = [h[p:p + 200] for h in (hap, hap2)
             for p in range(0, len(h) - 200 + 1, 100)]
    return _graph(tiles, k, device), reads


def gapfill_walk(g, links, reads):
    """The walk_linked call that align/correct.correct_batch makes to fill
    the gaps of `reads` (forced priming along the reads), as (state,
    keyword arguments).  The call itself runs as walk_linked runs it."""
    seen = []
    real = lwalk.walk_linked

    def spy(g_, links_, st, colour, **kw):
        seen.append((st, dict(kw, colour=colour)))
        return real(g_, links_, st, colour, **kw)

    lwalk.walk_linked = spy
    try:
        acorrect.correct_batch(g, links, reads)
    finally:
        lwalk.walk_linked = real
    assert len(seen) == 1
    return seen[0]


def gapfill_case(k, device, rlen=100, with_links=True, gbp=2000,
                 n_reads=128):
    """The gap-fill walk of diploid()'s reads on its graph, with the links
    of the reads (threaded without gap filling) or with none: (graph,
    links, state, keyword arguments)."""
    g, reads = diploid(k, device, gbp=gbp, n_reads=n_reads, rlen=rlen)
    links = (lthread.thread_reads(g, [(reads, 0)], 1) if with_links
             else lstore.empty(g.capacity, 1, device=device))
    st, kw = gapfill_walk(g, links, reads)
    return g, links, st, kw


def _path_vertices(g, seq):
    """The vertices (2 * row + orient) of seq's kmers, and whether each is
    in the graph."""
    idx, orient, valid = lthread.reads_to_node_paths(g, seq[None, :], g.k)
    n = len(seq) - g.k + 1
    v = (idx[0, :n].long() * 2 + orient[0, :n].long()).cpu().numpy()
    return v, valid[0, :n].cpu().numpy()


def random_links(g, verts, per_vertex, rng, max_nj=6, unseen=0.1):
    """A store with per_vertex[i] links at verts[i], random junctions of 1
    to max_nj bases, a share of them unseen in colour 0 (two colours)."""
    rows, ors, nj = [], [], []
    for v, n in zip(verts, per_vertex):
        rows += [v >> 1] * n
        ors += [v & 1] * n
        nj += list(rng.integers(1, max_nj + 1, n))
    L = len(rows)
    bases = rng.integers(0, 4, (L, max_nj)).astype(np.uint8)
    # distinct junctions at one vertex, so that no two links merge
    bases[:, 0] = np.arange(L) % 4
    bases[:, 1] = (np.arange(L) // 4) % 4
    nj = np.maximum(np.asarray(nj), 2)
    cols = np.where(rng.random(L) < unseen, 1, 0)
    return lstore.build_store(g.keys, np.asarray(rows), np.asarray(ors),
                              bases, nj, cols, 2)


def seeded(g, links, verts, max_len, ctpcol=0):
    v = torch.as_tensor(np.asarray(verts, np.int64))
    return lwalk.linked_init(g, links, (v >> 1).to(torch.int32),
                             (v & 1).to(torch.uint8), max_len, ctpcol)


def repeat_walks(k, device, n_links=20, colour=0, seed=1, every=9,
                 max_len=400):
    """Walkers on a genome holding a repeat unit twice (in-merges, and
    forks that the links of its reads resolve), with n_links random links
    more at each of 40 vertices before the first copy: more than 16 at a
    node (the pickup cap) and the 64 cursor slots full after four nodes
    (dropped pickups).  Walkers start at every `every`-th vertex of the
    genome and, reversed, at every (every + 4)-th, with room for max_len
    bases."""
    rng = np.random.default_rng(seed)
    unit = _dna(60, rng)
    genome = np.concatenate([_dna(150, rng), unit, _dna(120, rng), unit,
                             _dna(120, rng)])
    g = _graph([genome], k, device)
    reads = np.stack([genome[p:p + 100]
                      for p in range(0, len(genome) - 100, 10)])
    links = lthread.thread_reads(g, [(reads, 0), (3 - reads[:, ::-1], 0)], 2)
    verts, ok = _path_vertices(g, genome)
    verts = verts[ok]
    links = lstore.merge_stores(
        links, random_links(g, verts[60:100], [n_links] * 40, rng),
        g.capacity)
    seeds = np.concatenate([verts[::every], verts[::every + 4] ^ 1])
    st = seeded(g, links, seeds, max_len)
    return g, links, st, dict(colour=colour, max_steps=max_len + 100,
                              adj=adjmod.get_adjacency(g))


def cycle_walks(k, device, with_links=True, seed=2, ring_bp=150):
    """A circular genome of ring_bp: every walk runs round it until
    Brent's check finds the state repeating (cursors included, which keep
    changing while pickups fill the slots)."""
    rng = np.random.default_rng(seed)
    ring = _dna(ring_bp, rng)
    closed = np.concatenate([ring, ring[:k]])
    g = _graph([closed], k, device)
    verts, _ok = _path_vertices(g, closed)
    links = (random_links(g, verts[::7], [3] * len(verts[::7]), rng,
                          max_nj=3, unseen=0.0)
             if with_links else lstore.empty(g.capacity, 1, device=device))
    st = seeded(g, links, np.concatenate([verts[::11], verts[::17] ^ 1]),
                2000)
    return g, links, st, dict(colour=0, max_steps=3000,
                              adj=adjmod.get_adjacency(g))


def halt_walks(k, device, max_len, max_steps, seed=3):
    """Walks from 40 random kmers cut by max_steps or by the output's
    length (max_len)."""
    g, links, _st, kw = repeat_walks(k, device, n_links=3, seed=seed)
    rng = np.random.default_rng(seed)
    rows = torch.nonzero(g.covg[:, 0] != 0)[:, 0].cpu().numpy()
    seeds = rng.choice(rows, 40) * 2 + rng.integers(0, 2, 40)
    return (g, links, seeded(g, links, seeds, max_len),
            dict(kw, max_steps=max_steps))


def first_walkers(case, n):
    """The case cut to its first n walkers (every per-walker field of the
    state, and the forced priming)."""
    g, links, st, kw = case
    base = T.WalkState(**{f.name: getattr(st.base, f.name)[:n]
                          for f in dataclasses.fields(T.WalkState)})
    st = lwalk.LinkedWalkState(base=base, **{
        f.name: getattr(st, f.name) if f.name == "used"
        else getattr(st, f.name)[:n]
        for f in dataclasses.fields(lwalk.LinkedWalkState)
        if f.name != "base"})
    kw = {key: v[:n] if key in ("forced", "forced_n") and v is not None
          else v for key, v in kw.items()}
    return g, links, st, kw


def state_fields(st):
    """Every field of a LinkedWalkState (the base's too) as (name, numpy
    array)."""
    out = [(f.name, getattr(st.base, f.name))
           for f in dataclasses.fields(T.WalkState)]
    out += [(f.name, getattr(st, f.name))
            for f in dataclasses.fields(lwalk.LinkedWalkState)
            if f.name != "base"]
    return [(n, t.cpu().numpy()) for n, t in out]


def differing_fields(got, want):
    """Names of the fields of two states that differ in type, shape or any
    element."""
    bad = []
    for (name, a), (_n, b) in zip(state_fields(got), state_fields(want)):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad.append(name)
    return bad


def walk_both(g, links, st, kw, fused):
    """walk_linked on st by the kernel (fused, as the gate chooses on a
    card) or by the host loop."""
    real = lwalk._takes_kernel
    lwalk._takes_kernel = lambda w: fused
    try:
        return lwalk.walk_linked(g, links, st, **kw)
    finally:
        lwalk._takes_kernel = real

"""The port's walkers (mccortex_tpu_torch/graph/traverse.py) against
mccortex_tpu/graph/traverse.py on the CPU, on the graphs of
tests/test_traverse.py: a linear genome, a fork, a cycle, a colour-
restricted pair, a long genome cut by max_len, a junction-dense graph
(the hop cap grows and retries) and the 8 random graphs of
test_random_walks_match_reference.  Each graph is built once by the JAX
package and carried into the port with its full, sentinel-padded
arrays; the same seeds go through both.  Everything compared is an
integer or a string: exact equality, no tolerance.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import adjacency as jadj
from mccortex_tpu.graph import build as jb
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.graph import traverse as JT
from mccortex_tpu.graph import unitigs as ju
from mccortex_tpu_torch.graph import adjacency as tadj
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.graph import traverse as TT
from mccortex_tpu_torch.graph import unitigs as tu

from test_graph_build import batchify
from test_torch_unitigs import port_graph
from util import random_dna

MAX_LEN = 64   # one walker length, one capacity and one seed count for
CAP = 1024     # every graph, so JAX compiles once per (k, colours)
NSEEDS = 32
HOP_LEN = 4096  # the hop walker's max_len (hop cap 2048, as the CLI's)


def _random_inputs(seed):
    reads = [random_dna(70, seed=seed * 31 + i) for i in range(3)]
    reads.append(reads[0][30:] + reads[1][:30])
    return [(r, 0) for r in reads]


def _junction_inputs():
    seq = random_dna(400, seed=4040)
    inputs = [(seq, 0)]
    for pos in range(20, 380, 10):
        inputs.append((random_dna(15, seed=5000 + pos) + seq[pos:pos + 11],
                       0))
    return inputs


def _colour_inputs():
    shared = random_dna(60, seed=221)
    return [(shared + "A" + random_dna(30, seed=222), 0),
            (shared + "C" + random_dna(30, seed=223), 1)]


def _fork_inputs():
    stem = random_dna(40, seed=211)
    return [(stem + "A" + random_dna(30, seed=212), 0),
            (stem + "C" + random_dna(30, seed=213), 0)]


# name: (inputs, k, ncols)
GRAPHS = {
    "linear": ([(random_dna(300, seed=201), 0)], 11, 1),
    "fork": (_fork_inputs(), 7, 1),
    "cycle": ([("ACGGTCAGTACCTTGGCAAT" + "ACGGT", 0)], 5, 1),
    "colours": (_colour_inputs(), 9, 2),
    "maxlen": ([(random_dna(500, seed=231), 0)], 11, 1),
    "junctions": (_junction_inputs(), 11, 1),
    **{f"random{s}": (_random_inputs(s), 9, 1) for s in range(8)},
}


def build_padded(inputs, k, ncols):
    """The JAX package's graph of `inputs`, its live rows padded with
    sentinel rows to CAP."""
    jg = jb.build(batchify(inputs), k, ncols=ncols)
    n = int(jg.n)
    keys = np.full((CAP, jg.keys.shape[1]), np.uint64(2**64 - 1))
    covg = np.zeros((CAP, ncols), np.uint32)
    edges = np.zeros((CAP, ncols), np.uint8)
    keys[:n], covg[:n], edges[:n] = (np.asarray(a)[:n] for a in
                                     (jg.keys, jg.covg, jg.edges))
    return jstore.DBGraph(keys=jnp.asarray(keys), covg=jnp.asarray(covg),
                          edges=jnp.asarray(edges),
                          n=jnp.asarray(n, jnp.int64), k=k)


_built: dict = {}


def _case(name):
    """(name, JAX graph, port graph, seed rows), built once a module."""
    if name not in _built:
        jg = build_padded(*GRAPHS[name])
        n = int(jg.n)
        # NSEEDS - 1 live rows spread over the graph and one sentinel row
        rows = np.append(np.linspace(0, n - 1, NSEEDS - 1).astype(np.int64),
                         n)
        _built[name] = (name, jg, port_graph(jg), rows)
    return _built[name]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    return _case(request.param)


# the hop walker's own test: every graph but the random ones after the
# first, which reach hop_walk through the assembler's test
@pytest.fixture(scope="module",
                params=[g for g in GRAPHS if not g.startswith("random")]
                + ["random0"])
def hop_graph(request):
    return _case(request.param)


def _np(x):
    """A state field as numpy, uint64 where the port carries int64 bits."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _state_equal(got, want, fields):
    for f in fields:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        if b.dtype == np.uint64:
            a = a.view(np.uint64)
        np.testing.assert_array_equal(a, b, err_msg=f)


WALK_FIELDS = [f.name for f in dataclasses.fields(TT.WalkState)]
HOP_FIELDS = [f.name for f in dataclasses.fields(TT.HopState)]


def _colours(jg):
    return [0, None] if jg.covg.shape[1] == 1 else [0, 1, None]


def test_walk_matches_jax(graph):
    """walk_init + walk, with and without the adjacency, in every colour
    and in none: every WalkState field equal."""
    name, jg, tg, rows = graph
    B = len(rows)
    jadjc = jadj.get_adjacency(jg)
    tadjc = tadj.get_adjacency(tg)
    # colour 0 with the adjacency, every other colour and none without
    # it, over both orientations (colour 0 with the adjacency is also
    # the walk of assemble_linkless_contigs_steps)
    cases = [(0, 0, True), (1, None, False)]
    if jg.covg.shape[1] > 1:
        cases.append((1, 1, True))
    for o, colour, use_adj in cases:
        js0 = JT.walk_init(jg, jnp.asarray(rows, jnp.int32),
                           jnp.full((B,), o, jnp.uint8), MAX_LEN)
        ts0 = TT.walk_init(tg, torch.from_numpy(rows),
                           torch.full((B,), o, dtype=torch.uint8), MAX_LEN)
        _state_equal(ts0, js0, WALK_FIELDS)
        js = JT.walk(jg, js0, colour, MAX_LEN + 1,
                     adj=jadjc if use_adj else None)
        ts = TT.walk(tg, ts0, colour, MAX_LEN + 1,
                     adj=tadjc if use_adj else None)
        _state_equal(ts, js, WALK_FIELDS)


def test_walk_chunked_matches_jax(graph):
    """walk_chunked in chunks of 13 steps: the same state as JAX's (and
    so as one walk() over every step, which test_walk_matches_jax
    holds)."""
    name, jg, tg, rows = graph
    B = len(rows)
    js = JT.walk_init(jg, jnp.asarray(rows, jnp.int32),
                      jnp.zeros((B,), jnp.uint8), MAX_LEN)
    ts = TT.walk_init(tg, torch.from_numpy(rows),
                      torch.zeros((B,), dtype=torch.uint8), MAX_LEN)
    tadjc = tadj.get_adjacency(tg)
    jc = JT.walk_chunked(jg, js, 0, MAX_LEN + 1,
                         adj=jadj.get_adjacency(jg), chunk=13)
    tc = TT.walk_chunked(tg, ts, 0, MAX_LEN + 1, adj=tadjc, chunk=13)
    _state_equal(tc, jc, WALK_FIELDS)


def test_hop_walk_matches_jax(hop_graph):
    """hop_walk from both orientations of every seed, in every colour:
    every HopState field equal (the record buffers, counts, statuses,
    visited sets and Brent fields)."""
    name, jg, tg, rows = hop_graph
    jue = jstore.cached_union_edges(jg)
    tue = tstore.cached_union_edges(tg)
    juv = ju.cached_unitig_view(jg.keys, jue, jg.k)
    tuv = tu.cached_unitig_view(tg.keys, tue, tg.k)
    jadjc, tadjc = jadj.get_adjacency(jg), tadj.get_adjacency(tg)
    for o in (0, 1):
        sv = rows * 2 + o
        for colour in _colours(jg):
            js = JT.hop_walk(jg, juv, jnp.asarray(sv, jnp.int32), colour,
                             HOP_LEN, jadjc, jue)
            ts = TT.hop_walk(tg, tuv, torch.from_numpy(sv).to(torch.int32),
                             colour, HOP_LEN, tadjc, tue)
            _state_equal(ts, js, HOP_FIELDS)


def test_assemble_linkless_contigs_match_jax(graph):
    """Contig strings and stop codes of both assemblers, equal to JAX's,
    in colour 0 (every colour and none on the two-colour graph); the
    maxlen graph at max_len 50 (a HitMaxLen halt)."""
    name, jg, tg, rows = graph
    max_len = 50 if name == "maxlen" else HOP_LEN
    for colour in _colours(jg) if jg.covg.shape[1] > 1 else [0]:
        jc, jst = JT.assemble_linkless_contigs(jg, rows, colour=colour,
                                               max_len=max_len)
        tc, tst = TT.assemble_linkless_contigs(tg, rows, colour=colour,
                                               max_len=max_len)
        assert tc == jc
        np.testing.assert_array_equal(tst, jst)
    jc, jst = JT.assemble_linkless_contigs_steps(jg, rows, colour=0,
                                                 max_len=MAX_LEN)
    tc, tst = TT.assemble_linkless_contigs_steps(tg, rows, colour=0,
                                                 max_len=MAX_LEN)
    assert tc == jc
    np.testing.assert_array_equal(tst, jst)
    if name == "maxlen":
        assert (tst == TT.HALT_MAXLEN).any()
    if name == "cycle":
        assert (tst == TT.HALT_CYCLE).any()


def test_hop_cap_growth_matches_jax(monkeypatch):
    """The junction-dense graph with a starting hop cap of 4: both
    packages grow the cap, retry, and give the contig of an unbounded
    cap."""
    from mccortex_tpu.ops import kmer as jkops
    from mccortex_tpu.ops import sorted as jsops
    from util import seq_to_codes
    inputs, k, _ = GRAPHS["junctions"]
    jg = build_padded(*GRAPHS["junctions"])
    tg = port_graph(jg)
    key, _ = jkops.canonical(jkops.pack_kmers(
        jnp.asarray(seq_to_codes(inputs[0][0][:k])[None]), k), k)
    row, found = jsops.lookup(jg.keys, key)
    assert bool(found[0])
    seed = np.asarray(row).astype(np.int64)
    want = TT.assemble_linkless_contigs(tg, seed, colour=0, max_len=1024)
    caps = []
    real = TT._hop_walk_once

    def spy(*a):
        caps.append(a[-1])
        return real(*a)

    monkeypatch.setattr(JT, "HOP_CAP0", 4)
    monkeypatch.setattr(TT, "HOP_CAP0", 4)
    monkeypatch.setattr(TT, "_hop_walk_once", spy)
    jc, jst = JT.assemble_linkless_contigs(jg, seed, colour=0, max_len=1024)
    tc, tst = TT.assemble_linkless_contigs(tg, seed, colour=0, max_len=1024)
    assert tc == jc == want[0]
    np.testing.assert_array_equal(tst, jst)
    assert max(caps) > 4 and len(tc[0]) >= 200


def test_choose_linkless_every_nibble_pair():
    pop, col = np.meshgrid(np.arange(16, dtype=np.uint8),
                           np.arange(16, dtype=np.uint8), indexing="ij")
    pop, col = pop.reshape(-1), col.reshape(-1)
    want = JT.choose_linkless(jnp.asarray(pop), jnp.asarray(col))
    got = TT.choose_linkless(torch.from_numpy(pop), torch.from_numpy(col))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_brent_update_every_case():
    """Every (moved, hash equal, checkpoint due) combination, each with
    steps and limits on both sides of the checkpoint."""
    rng = np.random.default_rng(7)
    B = 256
    h = rng.integers(0, 2**63, B, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, B, dtype=np.uint64)
    old = np.where(rng.random(B) < 0.5, h, h ^ np.uint64(1 << 63))
    steps = rng.integers(0, 9, B).astype(np.int32)
    limit = (2 ** rng.integers(0, 4, B)).astype(np.int32)
    moved = rng.random(B) < 0.7
    B_ = (B,)

    def state(mod, tensor, u64):
        z = tensor(np.zeros(B_, np.int32))
        return mod.WalkState(
            idx=z, orient=tensor(np.zeros(B_, np.uint8)),
            okm=tensor(np.zeros((B, 1), u64)), active=tensor(moved),
            status=z, nsteps=z, brent_hash=tensor(old.view(u64)),
            brent_steps=tensor(steps), brent_limit=tensor(limit),
            out_bases=tensor(np.zeros((B, 1), np.uint8)),
            out_vert=tensor(np.zeros((B, 1), np.int32)), out_len=z)

    js, jcyc = JT.brent_update(state(JT, jnp.asarray, np.uint64),
                               jnp.asarray(h), jnp.asarray(moved))
    ts, tcyc = TT.brent_update(state(TT, torch.from_numpy, np.int64),
                               torch.from_numpy(h.view(np.int64)),
                               torch.from_numpy(moved))
    np.testing.assert_array_equal(tcyc.numpy(), np.asarray(jcyc))
    assert np.asarray(jcyc).any() and not np.asarray(jcyc).all()
    _state_equal(ts, js, ["brent_hash", "brent_steps", "brent_limit"])


def test_emit_chars_match_jax(graph):
    name, jg, tg, rows = graph
    np.testing.assert_array_equal(
        TT.cached_emit_chars(tg.keys, tg.k),
        np.asarray(JT._emit_chars(jg.keys, jg.k)))
    assert TT.cached_emit_chars(tg.keys, tg.k) is \
        TT.cached_emit_chars(tg.keys, tg.k)

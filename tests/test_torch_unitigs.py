"""The port's adjacency, unitig and unitig-graph modules against
mccortex_tpu on the same graphs, on the CPU.  Each graph is built by the
JAX package and carried into the port with its full, sentinel-padded
arrays, so both sides see the same rows.  Integer outputs and text:
exact equality, no tolerance.  `dist` is compared on chain vertices
only: on a cycle it is unspecified (mccortex_tpu/graph/unitigs.py:39).
"""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import adjacency as jadj
from mccortex_tpu.graph import build as jb
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.graph import unitig_graph as jug
from mccortex_tpu.graph import unitigs as ju
from mccortex_tpu_torch.graph import adjacency as tadj
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.graph import unitig_graph as tug
from mccortex_tpu_torch.graph import unitigs as tu

from test_graph_build import batchify
from util import random_dna


def port_graph(jg) -> tstore.DBGraph:
    """The JAX store's full arrays (padding included) as a port store."""
    return tstore.DBGraph(
        keys=torch.from_numpy(np.array(jg.keys).view(np.int64)),
        covg=torch.from_numpy(np.array(jg.covg).view(np.int32)),
        edges=torch.from_numpy(np.array(jg.edges)),
        n=int(jg.n), k=jg.k)


def _inputs(kind, k):
    if kind == "fork":
        stem = random_dna(30, seed=10 + k)
        return [(stem + "A" + random_dna(20, seed=11 + k), 0),
                (stem + "C" + random_dna(20, seed=12 + k), 0),
                (stem + "C" + random_dna(20, seed=12 + k), 0)]
    if kind == "cycle":
        core = random_dna(40, seed=k)
        return [(core + core[:k], 0), (core[5:] + core[:k + 5], 0)]
    reads = [random_dna(60, seed=k * 10 + i) for i in range(5)]
    # overlaps make joins and forks; repeats raise the coverage
    reads.append(reads[0][20:] + reads[1][:20])
    reads.append(reads[2][:40] + reads[3][10:])
    return [(r, 0) for r in reads] + [(reads[4], 0)] * 2


CASES = [("fork", 5), ("fork", 11), ("cycle", 5), ("cycle", 31),
         ("random", 5), ("random", 11), ("random", 31), ("random", 33)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-k{b}" for a, b in CASES])
def graph(request):
    kind, k = request.param
    jg = jb.build(batchify(_inputs(kind, k)), k, ncols=1)
    return jg, port_graph(jg)


def _eq(got: torch.Tensor, want, mask=None):
    got, want = got.numpy(), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_array_equal(got, want)


def test_adjacency_and_successors_match_jax(graph):
    jg, tg = graph
    adj = tadj.get_adjacency(tg)
    assert adj.dtype == torch.int32 and adj.shape == (8 * tg.capacity,)
    _eq(adj, jadj.build_adjacency(jg.keys, jg.k))
    assert tadj.get_adjacency(tg) is adj
    assert tadj.cached_adjacency_for(tg.keys, tg.k) is adj
    v = torch.arange(2 * tg.capacity)
    _eq(tadj.adj_at(adj, v, 3), jadj.adj_at(jadj.build_adjacency(
        jg.keys, jg.k), jnp.arange(2 * jg.capacity), 3))
    ue = tstore.union_edges(tg)
    _eq(tu.successors(tg.keys, ue, tg.k),
        ju.successors(jg.keys, jstore.union_edges(jg), jg.k))


def test_unitig_view_and_stats_match_jax(graph):
    jg, tg = graph
    juv, jmed, jtip, jext = ju.unitig_stats(jg)
    tuv, tmed, ttip, text = tu.unitig_stats(tg)
    for f in ("succ", "end", "uid", "length", "is_cycle"):
        _eq(getattr(tuv, f), getattr(juv, f))
    chain = ~np.repeat(np.asarray(juv.is_cycle), 2)
    _eq(tuv.dist, juv.dist, chain)
    _eq(tmed, jmed)
    _eq(ttip, jtip)
    _eq(text, jext)
    # memoised on the (keys, union edges) tensors
    ue = tstore.cached_union_edges(tg)
    assert tu.cached_unitig_view(tg.keys, ue, tg.k) is tuv


def test_extract_unitigs_matches_jax(graph):
    jg, tg = graph
    want = ju.extract_unitigs(jg)
    assert tu.extract_unitigs(tg) == want and len(want) >= 1


def test_gfa_and_dot_match_jax(graph):
    jg, tg = graph
    seqs = ju.extract_unitigs(jg)
    assert tug.unitig_links(tg, seqs) == jug.unitig_links(jg, seqs)
    for write, kw in ((("write_gfa"), {}), ("write_dot", {}),
                      ("write_dot", {"points": True})):
        a, b = io.StringIO(), io.StringIO()
        getattr(tug, write)(a, tg, seqs, **kw)
        getattr(jug, write)(b, jg, seqs, **kw)
        assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("V,seed", [(1, 0), (7, 1), (64, 2), (1001, 3),
                                    (5000, 4)])
def test_pointer_doubling_matches_jax(V, seed):
    """Random successor arrays: chains into ends, and permutation cycles,
    each vertex with at most one predecessor."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(V)
    succ = np.full(V, -1, np.int32)
    i = 0
    while i < V:                       # cut perm into chains and cycles
        ln = int(rng.integers(1, 40))
        run = perm[i:i + ln]
        succ[run[:-1]] = run[1:]
        if rng.random() < 0.3 and len(run) > 1:
            succ[run[-1]] = run[0]
        i += ln
    jp, jd, jm = ju.pointer_doubling(jnp.asarray(succ))
    tp, td, tm = tu.pointer_doubling(torch.from_numpy(succ))
    _eq(tp, jp)          # same pass count: cycle vertices' ends agree
    _eq(tm, jm)
    chain = np.asarray(succ)[np.asarray(jp)] < 0
    _eq(td, jd, chain)


def test_empty_graph_has_no_unitigs():
    g = tstore.empty(31, 1, 1, "cpu")
    assert tu.extract_unitigs(g) == []
    assert tug.unitig_links(g, []) == []

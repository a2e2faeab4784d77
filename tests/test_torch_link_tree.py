"""The port's link trees (mccortex_tpu_torch/links/link_tree.py) against
mccortex_tpu.links.link_tree on the CPU, exactly (tolerance 0: every
value compared is an integer, a bool or text).

The graphs are those of tests/test_link_tree.py (k = 9: two reads
prefixes merging into a shared middle that forks twice, seen at several
depths), built by the port, padded with sentinel rows to one capacity
and carried into the JAX package; the JAX package threads the links and
the port reads the same store, so each case tests the link tree alone.
"""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.links import link_tree as jlt
from mccortex_tpu.links import thread as jth
from mccortex_tpu_torch.links import link_tree as tlt
from mccortex_tpu_torch.links import store as tls

from test_graph_build import batchify
from test_link_tree import two_junction_layout
from test_torch_links import graphs

K = 9


def _reads(case):
    p1, p2, common, a, b, mid, c, d = two_junction_layout()
    return {
        # tests/test_link_tree.py::test_clean_truncates_tail_not_whole_link
        "truncate": [p1 + common + a + mid + c] * 5
        + [p1 + common + a + mid + d] + [p1 + common + b] * 3
        + [p2 + common + b],
        # ::test_clean_merges_prefixes
        "merge": [p1 + common + a + mid + c] * 2
        + [p1 + common + a + mid + d] * 2 + [p1 + common + b] * 2
        + [p2 + common + b],
        # ::test_covg_hist_and_threshold
        "hist": [p1 + common + a + mid + c] * 20
        + [p1 + common + a + mid + d] + [p1 + common + b] * 10
        + [p2 + common + b],
        # ::test_trace_ok_is_walkability
        "walk": [p1 + common + a] * 3 + [p1 + common + b] * 2
        + [p2 + common + a],
    }[case]


CASES = ["truncate", "merge", "hist", "walk"]


@pytest.fixture(scope="module")
def trees():
    """Per case: (JAX graph, port graph, JAX links, the same links in the
    port), built once."""
    out = {}
    for case in CASES:
        reads = [(r, 0) for r in _reads(case)]
        jg, tg = graphs(reads, k=K)
        jl = jth.thread_reads(jg, batchify(reads), 1)
        out[case] = (jg, tg, jl, _port_links(jl))
    return out


def _port_links(jl):
    return tls.from_host(*(np.array(a) for a in (jl.offsets, jl.seq, jl.nj,
                                                  jl.nseen)), "cpu")


def _corrupt(jl):
    """Every link's first junction base flipped: the walk must fail."""
    seq = np.asarray(jl.seq) ^ np.uint64(3 << 62)
    return jl.replace(seq=jnp.asarray(seq))


def test_unpack_bases_matches_jax():
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 1 << 63, size=(50, 3), dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + np.uint64(1)
    nj = rng.integers(0, 96, 50)
    np.testing.assert_array_equal(tlt.unpack_bases(seq, nj),
                                  jlt.unpack_bases(seq, nj))


@pytest.mark.parametrize("record_bases", [False, True])
@pytest.mark.parametrize("case", CASES + ["walk_corrupt"])
def test_trace_juncpos_matches_jax(trees, case, record_bases):
    """jpos, ok, bases and lengths of every link, on the JAX package's
    store and on one whose junctions do not walk."""
    jg, tg, jl, tl = trees[case.split("_")[0]]
    if case.endswith("corrupt"):
        jl = _corrupt(jl)
        tl = _port_links(jl)
    want = jlt.trace_juncpos(jg, jl, record_bases=record_bases)
    got = tlt.trace_juncpos(tg, tl, record_bases=record_bases)
    for a, b, name in zip(got, want, ("jpos", "ok", "bases", "blen")):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert want[1].all() != case.endswith("corrupt")
    assert (want[0] >= 0).any() != case.endswith("corrupt")


def _views(trees, case):
    jg, tg, jl, tl = trees[case]
    jp, _, _, _ = jlt.trace_juncpos(jg, jl)
    return (tlt.LinkTreeView(tg, tl, jp), jlt.LinkTreeView(jg, jl, jp))


@pytest.mark.parametrize("case", CASES)
def test_link_tree_view_matches_jax(trees, case):
    """Every array of the view, keep_lengths, clean (store and stats),
    covg_hist and list_rows (before and after cleaning) at every
    cutoff from 1 to 6."""
    tv, jv = _views(trees, case)
    for name in ("order", "verts", "nj", "bases", "w", "jpos", "counts",
                 "rep", "gid"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    assert (tv.Jmax, tv.L, tv.colour, tv.ncols) == \
        (jv.Jmax, jv.L, jv.colour, jv.ncols)
    for cutoff in range(1, 7):
        keep = tv.keep_lengths(cutoff)
        np.testing.assert_array_equal(keep, jv.keep_lengths(cutoff))
        ts, tstats = tv.clean(cutoff)
        js, jstats = jv.clean(cutoff)
        assert tstats == jstats
        for a, b, name in zip(tls.to_host(ts), (js.offsets, js.seq, js.nj,
                                                 js.nseen),
                              ("offsets", "seq", "nj", "nseen")):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(tv.list_rows(keep),
                                      jv.list_rows(keep))
    np.testing.assert_array_equal(tv.list_rows(), jv.list_rows())
    for dist, covg in ((40, 100), (6, 3), (2, 12)):
        np.testing.assert_array_equal(tv.covg_hist(dist, covg),
                                      jv.covg_hist(dist, covg))


@pytest.mark.parametrize("case", CASES)
def test_suggest_cutoff_and_threshold_file_match_jax(trees, case):
    tv, jv = _views(trees, case)
    for dist, covg in ((40, 100), (6, 12), (1, 5)):
        hists = jv.covg_hist(dist, covg)
        got, want = tlt.suggest_cutoff(hists), jlt.suggest_cutoff(hists)
        assert got == want
        fa, fb = io.StringIO(), io.StringIO()
        tlt.write_threshold_file(fa, got)
        jlt.write_threshold_file(fb, want)
        assert fa.getvalue() == fb.getvalue()
    # a histogram whose rows the threshold picker can fit
    rng = np.random.default_rng(5)
    hists = rng.poisson(30 * np.exp(-np.arange(100) / 8.0), (8, 100))
    assert tlt.suggest_cutoff(hists) == jlt.suggest_cutoff(hists)


@pytest.mark.parametrize("case", CASES)
def test_write_dot_matches_jax(trees, case):
    """The DOT text of every kmer with links."""
    jg, tg, jl, tl = trees[case]
    offs = np.asarray(jl.offsets)
    deg = np.diff(offs)
    rows = np.nonzero((deg[0::2] + deg[1::2]) > 0)[0]
    assert len(rows)
    for row in rows.tolist():
        fa, fb = io.StringIO(), io.StringIO()
        tlt.write_dot(tg, tl, row, fa)
        jlt.write_dot(jg, jl, row, fb)
        assert fa.getvalue() == fb.getvalue(), row
        assert "->" in fa.getvalue()
    # a kmer with no links: the empty digraph on both
    fa, fb = io.StringIO(), io.StringIO()
    free = int(np.nonzero((deg[0::2] + deg[1::2]) == 0)[0][0])
    tlt.write_dot(tg, tl, free, fa)
    jlt.write_dot(jg, jl, free, fb)
    assert fa.getvalue() == fb.getvalue()


def test_view_of_one_used_colour_of_two(trees):
    """A 2-colour store whose counts live in colour 1 is cleaned in that
    colour and written back to it; counts in both colours are refused,
    as in the JAX package."""
    jg, tg, jl, _ = trees["truncate"]
    ns = np.zeros((jl.nlinks, 2), np.uint32)
    ns[:, 1] = np.asarray(jl.nseen)[:, 0]
    jl2 = jl.replace(nseen=jnp.asarray(ns))
    tl2 = _port_links(jl2)
    jp, _, _, _ = jlt.trace_juncpos(jg, jl2)
    tv, jv = tlt.LinkTreeView(tg, tl2, jp), jlt.LinkTreeView(jg, jl2, jp)
    assert tv.colour == jv.colour == 1
    ts, _ = tv.clean(3)
    js, _ = jv.clean(3)
    np.testing.assert_array_equal(tls.to_host(ts)[3], np.asarray(js.nseen))
    ns[:, 0] = 1
    with pytest.raises(ValueError, match="single-colour"):
        tlt.LinkTreeView(tg, _port_links(jl.replace(nseen=jnp.asarray(ns))),
                         jp)


def test_trace_on_an_empty_store(trees):
    jg, tg, _, _ = trees["walk"]
    empty = tls.empty(tg.capacity, 1, device="cpu")
    got = tlt.trace_juncpos(tg, empty, record_bases=True)
    assert got[0].shape == (0, 1) and got[2].shape == (0, 1024)
    assert isinstance(got[1], np.ndarray) and not len(got[1])
    assert tlt.LinkTreeView(tg, empty).clean(2)[1]["num_links"] == 0
    assert torch.equal(tlt.LinkTreeView(tg, empty).clean(2)[0].offsets,
                       empty.offsets)

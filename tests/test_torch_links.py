"""The port's link threading and linked walker (mccortex_tpu_torch/links/
{thread,walk,check}.py, align/correct.py) against mccortex_tpu on the
CPU, exactly (tolerance 0: everything compared is an integer, a string,
or a float32 confidence compared bit for bit).

One k = 11 graph holds the shapes of tests/test_links.py,
test_correct.py and test_check_links.py: two reads crossing a shared
middle (an X that links resolve), a genome with a 40 bp unit six times
over (repeats, hops) in two colours, and a fork with an unexplained
branch (the missing-information halt).  It is built once by the JAX
package, padded with sentinel rows to CAP and carried into the port;
every walk uses NSEEDS walkers and MAX_LEN, and the gap-fill batches
all have one error at one place in reads of one length, so that JAX
compiles each walker program once.

Each walker test runs a JAX entry point with its walk_linked and
walk_along calls recorded, then replays every recorded call on the port
from the same state (links/walk.state_from_numpy) and compares every
field of the state that comes out; the entry points' own results are
compared too.
"""

import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.align import correct as jac
from mccortex_tpu.graph import adjacency as jadj
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.links import check as jchk
from mccortex_tpu.links import thread as jth
from mccortex_tpu.links import walk as jwalk
from mccortex_tpu_torch.align import correct as tac
from mccortex_tpu_torch.graph import adjacency as tadj
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.graph import traverse as TT
from mccortex_tpu_torch.links import check as tchk
from mccortex_tpu_torch.links import store as tls
from mccortex_tpu_torch.links import thread as tth
from mccortex_tpu_torch.links import walk as twalk

from test_graph_build import batchify
from test_links import canon, flanked
from util import random_dna, revcomp_str, seq_to_codes

K = 11
CAP = 2048      # every graph's capacity
NSEEDS = 32     # walkers of every assembler call
MAX_LEN = 1024  # every assembler's max_len
READ_LEN = 60   # gap-fill reads: one substitution at ERR_POS
ERR_POS = 30


def _sources():
    m = random_dna(40, seed=730)
    x1 = random_dna(30, seed=731) + m + random_dna(30, seed=732)
    x2 = random_dna(30, seed=733) + m + random_dna(30, seed=734)
    unit = random_dna(40, seed=910)
    rep = "".join(random_dna(60, seed=920 + i) + unit for i in range(6)) \
        + random_dna(60, seed=940)
    stem = random_dna(30, seed=371)
    y1 = random_dna(40, seed=370) + stem + "A" + random_dna(30, seed=372)
    y2 = random_dna(40, seed=374) + stem + "C" + random_dna(30, seed=373)
    return dict(x1=x1, x2=x2, rep=rep, y1=y1, y2=y2)


SRC = _sources()
REP_READS = [SRC["rep"][i:i + 50] for i in range(0, len(SRC["rep"]) - 50, 7)]
# colour 0: everything; colour 1: every other repeat read
GRAPH_IN = ([(SRC[s], 0) for s in ("x1", "x2", "y1", "y2")]
            + [(r, 0) for r in REP_READS] + [(r, 1) for r in REP_READS[::2]])
# threaded: all but the unexplained branch y2
THREAD_IN = ([(SRC[s], 0) for s in ("x1", "x2", "y1")]
             + [(r, 0) for r in REP_READS] + [(r, 1) for r in REP_READS[::2]])


def _mutate(s, pos):
    return s[:pos] + "ACGT"[("ACGT".index(s[pos]) + 1) % 4] + s[pos + 1:]


def _gap_batches():
    """Two batches of 16 reads of READ_LEN bp cut from the sources, each
    with one substitution at ERR_POS: one gap of K kmers a read, at one
    place, so every batch walks the same shapes."""
    rng = np.random.default_rng(11)
    srcs = [SRC["x1"], SRC["x2"], SRC["y1"], SRC["rep"], SRC["rep"]]
    reads = []
    for i in range(32):
        s = srcs[i % len(srcs)]
        p = int(rng.integers(0, len(s) - READ_LEN + 1))
        r = _mutate(s[p:p + READ_LEN], ERR_POS)
        reads.append(r if rng.random() < 0.5 else revcomp_str(r))
    codes = np.stack([seq_to_codes(r) for r in reads])
    return [(codes[:16], 0), (codes[16:], 0)]


def graphs(inputs, k=K, ncols=1):
    """(JAX store, port store) of `inputs`, padded with sentinel rows to
    CAP: built by the port (whose build writes mctx's graph, held by
    tests/test_torch_build.py) and carried into the JAX package, so that
    JAX compiles no build here."""
    tg = tb.build(batchify(inputs), k, ncols=ncols, device="cpu",
                  capacity=CAP)
    assert tg.capacity == CAP
    jg = jstore.DBGraph(
        keys=jnp.asarray(tg.keys.numpy().view(np.uint64)),
        covg=jnp.asarray(tg.covg.numpy().view(np.uint32)),
        edges=jnp.asarray(tg.edges.numpy()),
        n=jnp.asarray(tg.n, jnp.int64), k=k)
    return jg, tg


def _host(ls):
    if isinstance(ls.offsets, torch.Tensor):
        return tls.to_host(ls)
    return tuple(np.asarray(a) for a in (ls.offsets, ls.seq, ls.nj,
                                         ls.nseen))


def stores_equal(got, want):
    for a, b, name in zip(_host(got), _host(want),
                          ("offsets", "seq", "nj", "nseen")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def state_equal(got, want):
    """Every field of two LinkedWalkStates (the base's too); uint64 JAX
    fields against the port's int64 bit views, float32 bit for bit."""
    pairs = [(got.base, want.base, f.name)
             for f in dataclasses.fields(TT.WalkState)]
    pairs += [(got, want, f.name)
              for f in dataclasses.fields(twalk.LinkedWalkState)
              if f.name != "base"]
    for g, w, name in pairs:
        a, b = _np(getattr(g, name)), _np(getattr(w, name))
        if b.dtype == np.uint64:
            a = a.view(np.uint64)
        if b.dtype == np.float32:       # bit for bit
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def uni():
    """The graph and link store of both packages, and seed rows:
    NSEEDS - 1 live rows spread over the graph and one sentinel row."""
    jg, tg = graphs(GRAPH_IN, ncols=2)
    jl = jth.thread_reads(jg, batchify(THREAD_IN), 2)
    n = int(jg.n)
    seeds = np.append(np.linspace(0, n - 1, NSEEDS - 1).astype(np.int64), n)
    return dict(jg=jg, tg=tg, jl=jl, tl=tth.thread_reads(
        tg, batchify(THREAD_IN), 2), seeds=seeds, runs={})


class Recorder:
    """Records the JAX package's walk_linked and walk_along calls (their
    bound arguments and the state each returns) while installed."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("walk_linked", "walk_along"):
            real = getattr(jwalk, name)
            sig = inspect.signature(real)

            def spy(*a, _real=real, _sig=sig, _name=name, **kw):
                out = _real(*a, **kw)
                ba = _sig.bind(*a, **kw)
                ba.apply_defaults()
                self.calls.append((_name, dict(ba.arguments), out))
                return out

            monkeypatch.setattr(jwalk, name, spy)


def _port_arg(u, name, val, tl):
    """A recorded JAX argument as the port's."""
    if val is None or isinstance(val, (int, float, bool, str)):
        return val
    if name == "g":
        return u["tg"]
    if name == "links":
        return tl
    if name == "st":
        return twalk.state_from_numpy(val, "cpu")
    if name == "adj":
        return tadj.get_adjacency(u["tg"])
    if name == "hopinfo":
        return twalk.get_hopinfo(u["tg"], tl)
    return torch.from_numpy(np.asarray(val).copy())


def replay(u, calls, tl):
    """Each recorded call again on the port, from the same state: every
    field of the state that comes out equal.  Returns the calls seen."""
    seen = set()
    for name, args, want in calls:
        kw = {a: _port_arg(u, a, v, tl) for a, v in args.items()}
        got = getattr(twalk, name)(**kw)
        state_equal(got, want)
        seen.add(name)
        if name == "walk_linked":
            for opt in ("hopinfo", "forced", "conf_table"):
                if args[opt] is not None:
                    seen.add(opt)
            if args["missing_check"]:
                seen.add("missing_check")
            if args["track_used"]:
                seen.add("track_used")
    return seen


ENTRIES = {
    # name: the call, on (package, graph, links, seeds); the walks with
    # the missing-information check, the confidence model and used-link
    # marking, and assemble_contigs_from_paths, are those of `contigs -p
    # [-P -C -T]`, recorded and replayed by tests/test_torch_links_cli.py
    "linked": lambda m, g, l, s: m.assemble_contigs_linked(
        g, l, s, colour=0, max_len=MAX_LEN),
    "primed": lambda m, g, l, s: m.assemble_contigs_primed(
        g, l, s, colour=0, max_len=MAX_LEN, return_extra=True),
}


def _run_entry(u, name, monkeypatch):
    """The JAX entry point (recorded) and the port's, once a module."""
    if name not in u["runs"]:
        rec = Recorder(monkeypatch)
        jout = ENTRIES[name](jwalk, u["jg"], u["jl"], u["seeds"])
        monkeypatch.undo()
        tout = ENTRIES[name](twalk, u["tg"], u["tl"], u["seeds"])
        u["runs"][name] = (jout, tout, rec.calls)
    return u["runs"][name]


@pytest.mark.parametrize("name", list(ENTRIES))
def test_assemblers_match_jax(uni, name, monkeypatch):
    """Contigs, stop codes (and the primed walk's confidences, gaps and
    used links) equal to the JAX package's."""
    jout, tout, _calls = _run_entry(uni, name, monkeypatch)
    assert tout[0] == jout[0]
    np.testing.assert_array_equal(tout[1], jout[1])
    if len(jout) == 3:
        for key in ("cum_conf", "max_gap", "used"):
            np.testing.assert_array_equal(tout[2][key], jout[2][key],
                                          err_msg=key)
    assert max(map(len, tout[0])) > 2 * K


@pytest.mark.parametrize("name", list(ENTRIES))
def test_walk_linked_fields_match_jax(uni, name, monkeypatch):
    """Every walk_linked / walk_along call of the entry point, replayed on
    the port from the same state: every LinkedWalkState field equal
    (cold starts, priming and hops)."""
    _jout, _tout, calls = _run_entry(uni, name, monkeypatch)
    seen = replay(uni, calls, uni["tl"])
    want = {"linked": {"walk_linked", "hopinfo"},
            "primed": {"walk_linked", "walk_along", "hopinfo"}}[name]
    assert seen == want


def test_linked_init_matches_jax(uni):
    """linked_init at the seed rows in both orientations, and at link
    vertices (the pickup at the seed)."""
    lv = twalk.link_vertices(uni["tl"], CAP)[:NSEEDS]
    for rows, ors in ((uni["seeds"], np.zeros(NSEEDS, np.uint8)),
                      (uni["seeds"], np.ones(NSEEDS, np.uint8)),
                      (lv >> 1, (lv & 1).astype(np.uint8))):
        js = jwalk.linked_init(uni["jg"], uni["jl"],
                               jnp.asarray(rows, jnp.int32),
                               jnp.asarray(ors), MAX_LEN)
        ts = twalk.linked_init(uni["tg"], uni["tl"], torch.from_numpy(rows),
                               torch.from_numpy(ors), MAX_LEN)
        state_equal(ts, js)
    assert int((ts.cur_link >= 0).sum()) >= NSEEDS


def test_linked_hash_bit_for_bit():
    """_linked_hash over random cursor and counter slots (empty slots,
    high positions and ages): the JAX package's uint64, bit for bit; it
    decides the Brent cycle check."""
    rng = np.random.default_rng(5)
    B = 64

    def slots(n):
        lk = rng.integers(-1, 5000, (B, n)).astype(np.int32)
        lk[rng.random((B, n)) < 0.4] = -1
        return (lk, rng.integers(0, 200, (B, n)).astype(np.int32),
                rng.integers(0, 40, (B, n)).astype(np.int32))

    cur, cntr = slots(jwalk.CMAX), slots(jwalk.CMAX2)
    okm = rng.integers(0, 2**62, (B, 2), dtype=np.uint64)

    class S:
        pass

    js, ts = S(), S()
    js.base, ts.base = S(), S()
    js.base.okm, ts.base.okm = jnp.asarray(okm), torch.from_numpy(
        okm.view(np.int64))
    for name, arr in zip(("cur_link", "cur_pos", "cur_age", "cntr_link",
                          "cntr_pos", "cntr_age"), cur + cntr):
        setattr(js, name, jnp.asarray(arr))
        setattr(ts, name, torch.from_numpy(arr))
    want = np.asarray(jwalk._linked_hash(js))
    got = twalk._linked_hash(ts).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_first_true_is_jnp_argmax():
    """Rows of several True, of one and of none: the index jnp.argmax
    takes of a bool row (the first True, 0 for none)."""
    rng = np.random.default_rng(6)
    m = rng.random((200, 64)) < 0.1
    m[:10] = False
    m[10:20] = True
    want = np.asarray(jnp.argmax(jnp.asarray(m), axis=1))
    np.testing.assert_array_equal(
        twalk._first_true(torch.from_numpy(m)).numpy(), want)


def test_fill_hop_outputs_zero_past_out_len(uni, monkeypatch):
    """Reference fault, not copied: past a walker's out_len the JAX
    package's fill_hop_outputs returns whatever the buffers held (the
    2-bit packing reads it back as bases).  The port returns 0 and -1
    there, and the JAX package's values up to out_len."""
    jout, tout, calls = _run_entry(uni, "linked", monkeypatch)
    want = next(o for n, a, o in calls if n == "walk_linked"
                and a["hopinfo"] is not None)
    st = twalk.state_from_numpy(want, "cpu")
    B, L = st.base.out_bases.shape
    # garbage past out_len, as a state resumed after a longer walk holds
    j = torch.arange(L)[None, :] >= st.base.out_len[:, None]
    ob = torch.where(j, 2, st.base.out_bases).to(torch.uint8)
    ov = torch.where(j, 77, st.base.out_vert).to(torch.int32)
    st = st.replace(base=dataclasses.replace(st.base, out_bases=ob,
                                             out_vert=ov))
    jst = want.replace(base=want.base.replace(
        out_bases=jnp.asarray(ob.numpy()), out_vert=jnp.asarray(ov.numpy())))
    gb, gv = twalk.fill_hop_outputs(uni["tg"], st)
    wb, wv = jwalk.fill_hop_outputs(uni["jg"], jst)
    ol = st.base.out_len.numpy()
    past = np.arange(gb.shape[1])[None, :] >= ol[:, None]
    assert (gb[past] == 0).all() and (gv[past[:, :gv.shape[1]]] == -1).all()
    assert (wb[past] == 2).any()          # the JAX package's tail
    np.testing.assert_array_equal(np.where(past, 0, gb), np.where(past, 0,
                                                                   wb))
    np.testing.assert_array_equal(np.where(past[:, :gv.shape[1]], -1, gv),
                                  np.where(past[:, :wv.shape[1]], -1, wv))


def test_clipped_hop_lands_where_the_walk_does(uni):
    """Reference fault, not copied: a hop cut short by the room left in
    the output (J < jump[v]) moves the JAX package's walker to the full
    jump's target (mccortex_tpu/links/walk.py:732-738), so its output
    skips the vertices between; at the chunk boundaries of a long walk
    (room in the step budget) that makes contigs whose kmers are not in
    the graph.  The port's hop lands J positions ahead: with an output of
    8 every walker ends where a walk without hops ends, with the same
    output and status; JAX's clipped walkers end elsewhere."""
    rows = torch.from_numpy(uni["seeds"])
    ors = torch.zeros(NSEEDS, dtype=torch.uint8)
    tg, tl = uni["tg"], uni["tl"]
    adj = tadj.get_adjacency(tg)
    hop = twalk.get_hopinfo(tg, tl)

    def walk(h):
        st = twalk.linked_init(tg, tl, rows, ors, 8)
        return twalk.walk_linked(tg, tl, st, 0, MAX_LEN + 1, adj=adj,
                                 hopinfo=h)

    got, want = walk(hop), walk(None)
    last = (got.hop_cnt - 1).clamp(min=0).long()[:, None]
    hv = got.hop_v.gather(1, last)[:, 0].long()
    hn = got.hop_n.gather(1, last)[:, 0]
    clipped = (got.hop_cnt > 0) & (hn < hop[0][hv])
    assert clipped.sum() >= 4
    for f in ("idx", "orient", "okm", "out_len", "nsteps", "status",
              "active"):
        np.testing.assert_array_equal(getattr(got.base, f).numpy(),
                                      getattr(want.base, f).numpy(), f)
    for a, b in zip(twalk.fill_hop_outputs(tg, got),
                    twalk.fill_hop_outputs(tg, want)):
        np.testing.assert_array_equal(a, b)
    jst = jwalk.linked_init(uni["jg"], uni["jl"],
                            jnp.asarray(uni["seeds"], jnp.int32),
                            jnp.zeros(NSEEDS, jnp.uint8), 8)
    jst = jwalk.walk_linked(uni["jg"], uni["jl"], jst, 0,
                            max_steps=MAX_LEN + 1,
                            adj=jadj.get_adjacency(uni["jg"]),
                            hopinfo=jwalk.get_hopinfo(uni["jg"], uni["jl"]))
    off = np.asarray(jst.base.idx) != got.base.idx.numpy()
    assert off.any() and not off[~clipped.numpy()].any()


def test_reads_to_node_paths_match_jax(uni):
    """Node paths of the gap reads and of reads with N runs: valid equal,
    idx and orient equal where valid."""
    (b1, _), (b2, _) = _gap_batches()
    rows = np.concatenate([b1, b2])
    rows[::3, 5:9] = 4
    for bases in (rows, rows[:, :K - 1]):
        ji, jo, jv = (np.asarray(a) for a in
                      jth.reads_to_node_paths(uni["jg"], bases, K))
        ti, to, tv = (a.numpy() for a in
                      tth.reads_to_node_paths(uni["tg"], bases, K))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti[jv], ji[jv])
        np.testing.assert_array_equal(to[jv], jo[jv])
        assert ti.dtype == np.int32 and to.dtype == np.uint8


def test_thread_reads_match_jax(uni):
    """The link store of the threaded reads (two colours) and the
    threading statistics: equal to JAX's."""
    stores_equal(uni["tl"], uni["jl"])
    assert uni["tl"].nlinks > 20
    js, ts = jth.ThreadStats(2), tth.ThreadStats(2)
    jth.thread_reads(uni["jg"], batchify(THREAD_IN[:4]), 2, stats=js)
    tth.thread_reads(uni["tg"], batchify(THREAD_IN[:4]), 2, stats=ts)
    assert ts.contig_hists == js.contig_hists and ts.contig_hists[0]


def test_junction_records_in_one_pass(uni):
    """Reference fault, not copied: the JAX package sizes the record
    buffer from a process-wide hint (_REC_CAP_HINT) that only grows, and
    grows and retries on overflow.  The port takes the exact count in one
    pass: a batch of more than 4 records a read (junction-dense repeat
    reads) gives JAX's links, with no cap state left behind."""
    assert not hasattr(tth, "_REC_CAP_HINT")
    reads = [(SRC["rep"], 0)] * 3
    jl = jth.thread_reads(uni["jg"], batchify(reads), 1)
    tl = tth.thread_reads(uni["tg"], batchify(reads), 1)
    stores_equal(tl, jl)
    idx, orient, valid = tth.reads_to_node_paths(
        uni["tg"], batchify(reads)[0][0], K)
    recs = tth._junction_records(uni["tg"], idx, orient, valid, K, 0)
    assert recs.shape[1] > 4 * 3


GAPFILL = {
    "one_way": dict(),
    "two_way": dict(one_way=False),
    "links_prev": dict(links_prev="L1"),
    "use_new_paths": dict(use_new_paths=True),
    "links_prev_new_paths": dict(links_prev="L1", use_new_paths=True),
    "no_end_check": dict(end_check=False, max_context=8),
}


def _stats_equal(got, want):
    for f in dataclasses.fields(jac.CorrectAlnStats):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _l1(u):
    """Links of gap-filled batch 1 (both packages), the links_prev of the
    gap-fill cases."""
    if "L1" not in u:
        b1 = _gap_batches()[:1]
        u["L1"] = (jth.thread_reads_gapfill(u["jg"], b1, 1),
                   tth.thread_reads_gapfill(u["tg"], b1, 1))
    return u["L1"]


@pytest.mark.parametrize("case", list(GAPFILL))
def test_gapfill_matches_jax(uni, case, monkeypatch):
    """thread_reads_gapfill over the two gap batches: the link store, the
    threading statistics and every CorrectAlnStats counter equal; the
    walks of its first batch replayed field by field (forced priming)."""
    kw = dict(GAPFILL[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("links_prev") == "L1":
        jkw["links_prev"], tkw["links_prev"] = _l1(uni)
    batches = _gap_batches()
    jst, tst = jth.ThreadStats(1), tth.ThreadStats(1)
    ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
    rec = Recorder(monkeypatch)
    jl = jth.thread_reads_gapfill(uni["jg"], batches, 1, stats=jst,
                                  aln_stats=ja, **jkw)
    monkeypatch.undo()
    tl = tth.thread_reads_gapfill(uni["tg"], batches, 1, stats=tst,
                                  aln_stats=ta, **tkw)
    stores_equal(tl, jl)
    assert tst.contig_hists == jst.contig_hists
    _stats_equal(ta, ja)
    assert ja.num_gap_successes > 0 and tl.nlinks > 0
    name, args, want = rec.calls[0]
    links_t = tkw.get("links_prev")
    if links_t is None:
        links_t = tls.empty(CAP, 1, device="cpu")
    assert replay(uni, [(name, args, want)], links_t) == {
        "walk_linked", "forced"}


def test_correct_batch_matches_jax(uni):
    """correct_batch of gap batch 1 with links, and without links of it
    with one read made of two unrelated halves (a gap no walk bridges):
    every CorrectedRead (path, sequence, display, gaps, fixes) and every
    counter equal."""
    bases = _gap_batches()[0][0]
    nrun = bases.copy()
    nrun[3] = seq_to_codes(SRC["x1"][:30] + SRC["y1"][40:70])
    jl1, tl1 = _l1(uni)
    for b, jlinks, tlinks in ((bases, jl1, tl1), (nrun, None, None)):
        ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
        want = jac.correct_batch(uni["jg"], jlinks, b, aln_stats=ja)
        got = tac.correct_batch(uni["tg"], tlinks, b, aln_stats=ta)
        _reads_equal(got, want)
        _stats_equal(ta, ja)
        assert any(r.nfixed for r in got)
    assert got[3].nfixed == 0 and got[3].display != got[3].display.upper()


def _reads_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.verts, b.verts)
        assert (a.seq, a.display, a.ngaps, a.nfixed) == \
            (b.seq, b.display, b.ngaps, b.nfixed)


def _twoway_graph():
    """tests/test_correct_twoway.py's fixture, built by the port: a read
    gap holding a forward fork (the left walker halts there) and a
    forward merge (the right walker halts there); only two-way bridges
    it."""
    from test_correct_twoway import _alt, _degrees
    seed = 800
    while True:
        genome = random_dna(130, seed=seed)
        py, px = 55, 66
        inputs = [(genome, 0),
                  (genome[px - 2:px + K] + _alt(genome[px + K]), 0),
                  (_alt(genome[py - 1]) + genome[py:py + K + 2], 0)]
        seed += 1
        if _degrees(inputs, K, genome[px:px + K])[0] == 2 and \
                _degrees(inputs, K, genome[py:py + K])[1] == 2:
            return graphs(inputs), genome, genome[:50] + "N" * 30 + \
                genome[80:]


@pytest.mark.parametrize("one_way", [True, False])
def test_correct_two_way_matches_jax(one_way):
    (jg, tg), genome, bad = _twoway_graph()
    arr = np.asarray(seq_to_codes(bad)[None])
    ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
    want = jac.correct_batch(jg, None, arr, one_way=one_way, aln_stats=ja)
    got = tac.correct_batch(tg, None, arr, one_way=one_way, aln_stats=ta)
    _reads_equal(got, want)
    _stats_equal(ta, ja)
    assert (got[0].seq == genome) == (not one_way)


def test_correct_batch_mate_col_matches_jax(uni):
    """The mate-pair layout (r1 + a break + revcomp(r2)): the insert gap's
    window comes from the fragment lengths; reads, counters and the
    fragment histogram equal."""
    pairs = [(SRC[n][:40], revcomp_str(SRC[n][60:100]))
             for n in ("x1", "x2", "y1", "rep")]
    rows = np.stack([np.concatenate([seq_to_codes(a), [4],
                                     seq_to_codes(revcomp_str(b))])
                     for a, b in pairs]).astype(np.uint8)
    ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
    kw = dict(mate_col=40, frag_len_min=80, frag_len_max=120)
    want = jac.correct_batch(uni["jg"], None, rows, aln_stats=ja, **kw)
    got = tac.correct_batch(uni["tg"], None, rows, aln_stats=ta, **kw)
    _reads_equal(got, want)
    _stats_equal(ta, ja)
    assert ta.num_ins_gaps == 4 and ta.fraglen_histgrm.any()


@pytest.mark.parametrize("corrupt", [False, True])
def test_check_links_matches_jax(uni, corrupt):
    """check_links on the threaded store, and on a copy with every link's
    first junction base changed (tests/test_check_links.py)."""
    jl, tl = uni["jl"], uni["tl"]
    if corrupt:
        seq = np.asarray(jl.seq).copy()
        seq[:, 0] ^= np.uint64(1) << np.uint64(63)
        jl = jl.replace(seq=jnp.asarray(seq))
        tl = dataclasses.replace(tl, seq=torch.from_numpy(seq.view(np.int64)))
    want = jchk.check_links(uni["jg"], jl)
    got = tchk.check_links(uni["tg"], tl)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    assert (want[1] > 0) == corrupt and want[0] >= jl.nlinks


def test_fetch_link_paths_matches_jax(uni):
    lids = np.arange(uni["jl"].nlinks)
    want = jwalk.fetch_link_paths(uni["jg"], uni["jl"], lids,
                                  adj=jadj.get_adjacency(uni["jg"]))
    got = twalk.fetch_link_paths(uni["tg"], uni["tl"], lids,
                                 adj=tadj.get_adjacency(uni["tg"]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert want[2].all()


def test_pickup_overflow_counted():
    """More than 16 links on one vertex (a ladder of four forks under a
    shared core, tests/test_links.py::test_pickup_overflow_counted): the
    port counts the pickups it drops and report_drops warns about them."""
    import contextlib
    import io
    import itertools
    k = 9
    core = random_dna(20, seed=555)
    s1, s2, s3 = (random_dna(14, seed=x) for x in (556, 557, 559))
    tail = random_dna(14, seed=558)
    seqs = [(core + a + s1 + b + s2 + c + s3 + d + tail, 0)
            for a, b, c, d in itertools.product("ACGT", repeat=4)]
    g = tb.build(batchify(seqs), k, device="cpu")
    links = tth.thread_reads(g, batchify(seqs), 1)
    cnt = np.diff(links.offsets.numpy())
    v = int(cnt.argmax())
    assert cnt[v] > 16
    st = twalk.linked_init(g, links, torch.tensor([v >> 1]),
                           torch.tensor([v & 1], dtype=torch.uint8), 80)
    st = twalk.walk_linked(g, links, st, 0, max_steps=60)
    nd = int(st.n_drop.sum())
    assert nd > 0
    twalk.DROP_COUNTS.clear()
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert twalk.report_drops(st, "testctx") == nd
    assert "link pickups dropped during testctx" in buf.getvalue()
    assert twalk.DROP_COUNTS["testctx"] == nd


def _port_row(g, kmer: str) -> int:
    from mccortex_tpu_torch.ops import kmer as tk
    from mccortex_tpu_torch.ops import sorted as ts
    key, _ = tk.canonical(tk.pack_kmers(
        torch.from_numpy(seq_to_codes(kmer)[None]), g.k), g.k)
    row, found = ts.lookup(g.keys, key)
    assert bool(found[0]), kmer
    return int(row[0])


@pytest.mark.parametrize("glen,seed", [(500, 1), (2000, 2)])
def test_lossless_reconstruction_on_the_port(glen, seed):
    """tests/test_links.py::test_lossless_reconstruction on the port
    alone: a random sequence with unique flanks is rebuilt exactly from
    the port's graph and links at k = 9."""
    k = 9
    full = flanked(random_dna(glen, seed=1000 + seed), k, seed=seed)
    g = tb.build(batchify([(full, 0)]), k, device="cpu")
    links = tth.thread_reads(g, batchify([(full, 0)]), 1)
    seed_row = _port_row(g, full[:k])
    contigs, stats = twalk.assemble_contigs_linked(
        g, links, np.array([seed_row]), colour=0, max_len=len(full) + 100)
    assert canon(contigs[0]) == canon(full), (len(contigs[0]), len(full),
                                              stats)

"""The port's lookup layer (ops.kmer hashing, ops.hashidx, the lookup
kernel's plain version, ops.sorted's binary search, graph.store and
graph.edges helpers) against mccortex_tpu on the same numpy-seeded
inputs, on the CPU.  The JAX Pallas kernel runs with interpret=True, as
tests/test_pallas_lookup.py runs it.  Integer outputs: exact equality,
no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import edges as jedges
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.ops import hashidx as jh
from mccortex_tpu.ops import kmer as jk
from mccortex_tpu.ops import sorted as jsops
from mccortex_tpu.ops.pallas import lookup as jpl
from mccortex_tpu.utils import text as jtext
from mccortex_tpu_torch.graph import edges as tedges
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.ops import hashidx as th
from mccortex_tpu_torch.ops import kmer as tk
from mccortex_tpu_torch.ops import sorted as tsops
from mccortex_tpu_torch.ops.kernels import lookup as tl
from mccortex_tpu_torch.utils import text as ttext

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _keys(seed, n, W):
    rng = np.random.default_rng(seed)
    # valid canonical keys: word 0 below 2**62
    return np.unique(rng.integers(0, 1 << 62, size=(n, W), dtype=np.uint64),
                     axis=0)


def _queries(seed, keys, nq):
    """Half present, half absent, a few sentinels."""
    rng = np.random.default_rng(seed)
    W = keys.shape[1]
    q = np.concatenate([
        keys[rng.integers(0, len(keys), nq // 2)],
        rng.integers(0, 1 << 62, size=(nq - nq // 2, W), dtype=np.uint64)])
    q = q[rng.permutation(nq)]
    q[rng.integers(0, nq, 5)] = SENT
    return q


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["W1", "W2", "W3"])
def case(request):
    """A store, its queries and the answers of JAX's lookup kernel."""
    W = request.param
    keys = _keys(40 + W, 3000, W)
    q = _queries(50 + W, keys, 2001)
    t128, b128 = jpl.build_table128(keys)
    idx, found = jpl.lookup_fused(jnp.asarray(t128), jnp.asarray(q), b128,
                                  W, interpret=True)
    want = {"fused": (np.asarray(idx), np.asarray(found))}
    return dict(W=W, keys=keys, q=q, want=want)


def _check(got, want):
    idx, found = got
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(found.numpy(), want[1])


@pytest.mark.parametrize("W,seed", [(1, 0), (2, 1), (3, 2)])
def test_kmer_hash_matches_jax_and_host_mirror(W, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, size=(5000, W), dtype=np.uint64)
    keys[:3] = SENT
    want = np.asarray(jk.kmer_hash(jnp.asarray(keys)))
    got = _u64(tk.kmer_hash(_t(keys)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tk.kmer_hash_np(keys), jh._hash_np(keys))
    np.testing.assert_array_equal(got, tk.kmer_hash_np(keys))
    np.testing.assert_array_equal(
        _u64(tk.kmer_hash(_t(keys), seed=7)),
        np.asarray(jk.kmer_hash(jnp.asarray(keys), seed=7)))


@pytest.mark.parametrize("k", [5, 31, 33, 63])
def test_oriented_and_shift_append_match_jax(k):
    W = (2 * k + 63) // 64
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, size=(300, k)).astype(np.uint8)
    kmers = np.asarray(jk.pack_kmers(jnp.asarray(bases), k))
    orient = rng.integers(0, 2, 300).astype(np.uint8)
    nuc = rng.integers(0, 4, 300).astype(np.uint8)
    np.testing.assert_array_equal(
        _u64(tk.oriented(_t(kmers), torch.from_numpy(orient), k)),
        np.asarray(jk.oriented(jnp.asarray(kmers), jnp.asarray(orient), k)))
    np.testing.assert_array_equal(
        _u64(tk.shift_append(_t(kmers), torch.from_numpy(nuc), k)),
        np.asarray(jk.shift_append(jnp.asarray(kmers), jnp.asarray(nuc), k)))
    assert kmers.shape[1] == W


@pytest.mark.parametrize("W,b_bits", [(1, None), (2, None), (1, 1), (2, 1)])
def test_tables_byte_equal_to_jax(W, b_bits):
    """The reference-shaped 128-lane table, including the overflow retry
    from a b_bits that is far too small."""
    keys = _keys(60 + W, 4000, W)
    got = tl.build_table128(keys, b_bits=b_bits)
    want = jpl.build_table128(keys, b_bits=b_bits)
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.uint32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (1 << got[1], 128)


def test_lookup_plain_and_fused_on_cpu_match_jax_kernel(case):
    W, keys, q = case["W"], case["keys"], case["q"]
    table, bb = tl.build_table128(keys)
    tt = torch.from_numpy(table.view(np.int32))
    _check(tl.lookup_plain(tt, _t(q), bb, W), case["want"]["fused"])
    # the wrapper takes its plain version for CPU tensors
    _check(tl.lookup_fused(tt, _t(q), bb, W), case["want"]["fused"])
    # a batch shape is kept
    idx, found = tl.lookup_fused(tt, _t(q[:2000]).reshape(40, 50, W), bb, W)
    assert idx.shape == found.shape == (40, 50)


def _truth(keys, q):
    """(idx, found) by a search in the sorted unique keys (numpy)."""
    order = np.lexsort(keys.T[::-1])
    assert np.array_equal(order, np.arange(len(keys)))
    view = [tuple(r) for r in keys.tolist()]
    pos = {k: i for i, k in enumerate(view)}
    idx = np.array([pos.get(tuple(r), -1) for r in q.tolist()], np.int64)
    found = (idx >= 0) & ~(q == SENT).all(axis=1)
    return np.where(found, idx, 0).astype(np.int32), found


def _table32_layout(table, keys, bb):
    """Decode a 128-byte-row table: per stored key its store row, table
    row and slot; per table row its fill."""
    W = keys.shape[1]
    S = tl.slots_for(W, tl.ROW32)
    assert table.shape == (1 << bb, tl.ROW32) and table.dtype == np.uint32
    idxp = table[:, 2 * W * S:(2 * W + 1) * S]
    used = idxp != 0xFFFFFFFF
    fill = used.sum(axis=1)
    # slots fill from the front, the pad words stay empty
    assert np.array_equal(used, np.arange(S)[None, :] < fill[:, None])
    assert (table[:, (2 * W + 1) * S:] == 0xFFFFFFFF).all()
    r, s = np.nonzero(used)
    store = idxp[r, s].astype(np.int64)
    for w in range(W):
        got = (table[r, 2 * w * S + s].astype(np.uint64) << np.uint64(32)) \
            | table[r, (2 * w + 1) * S + s].astype(np.uint64)
        np.testing.assert_array_equal(got, keys[store, w])
    return store, r, fill, S


@pytest.mark.parametrize("W,n,b_bits", [(1, 3000, None), (2, 3000, None),
                                        (3, 3000, None), (4, 500, None),
                                        (1, 2500, 8), (2, 1500, 8),
                                        (3, 1000, 8), (1, 20, 1),
                                        (1, 3000, 1)])
def test_table32_invariant(W, n, b_bits):
    """Every live key is stored once; a key stored d rows from home has
    d full rows before it (modulo the number of rows)."""
    keys = _keys(80 + W, n, W)
    table, bb = tl.build_table32(keys, b_bits=b_bits)
    store, r, fill, S = _table32_layout(table, keys, bb)
    B = 1 << bb
    np.testing.assert_array_equal(np.sort(store), np.arange(len(keys)))
    home = (tk.kmer_hash_np(keys) >> np.uint64(64 - bb)).astype(
        np.int64)[store]
    d = (r - home) % B
    full = np.concatenate([[0], np.cumsum(np.tile(fill == S, 2))])
    # rows home .. home+d-1 (modulo B) are all full
    np.testing.assert_array_equal(full[home + d] - full[home], d)
    if b_bits is None:
        assert len(keys) <= tl.OCC32 * S * B < 2 * len(keys) + 2 * S
        assert d.max() <= 6 and (d > 0).mean() < 0.15
    else:
        assert bb == max(b_bits, int(np.ceil(np.log2(len(keys) / S))))


def test_table32_plain_lookup_matches_jax_kernel(case):
    """The 128-byte-row table gives the answers of JAX's lookup_fused on
    its own 128-lane table."""
    W, keys, q = case["W"], case["keys"], case["q"]
    table, bb = tl.build_table32(keys)
    tt = torch.from_numpy(table.view(np.int32))
    _check(tl.lookup_plain(tt, _t(q), bb, W), case["want"]["fused"])
    _check(tl.lookup_fused(tt, _t(q), bb, W), case["want"]["fused"])
    idx, found = tl.lookup_fused(tt, _t(q[:2000]).reshape(40, 50, W), bb, W)
    assert idx.shape == found.shape == (40, 50)
    rows = tl.rows_read(tt, _t(q), bb, W).numpy()
    assert ((rows == 0) == (q == SENT).all(axis=1)).all()
    assert rows.max() <= 6 and rows[rows > 0].mean() < 1.2


@pytest.mark.parametrize("W,n,b_bits", [(1, 2500, 8), (2, 1500, 8),
                                        (3, 1000, 8), (4, 700, 8)])
def test_table32_forced_chains_and_wrap(W, n, b_bits):
    """A small b_bits fills the table almost to the brim: chains of two
    and more rows, a chain that wraps past the last row, present, absent
    and sentinel queries."""
    keys = _keys(90 + W, n, W)
    table, bb = tl.build_table32(keys, b_bits=b_bits)
    assert bb == b_bits
    store, r, fill, S = _table32_layout(table, keys, bb)
    home = (tk.kmer_hash_np(keys) >> np.uint64(64 - bb)).astype(
        np.int64)[store]
    assert ((r - home) % (1 << bb)).max() >= 2
    assert (r < home).any()                     # stored past the last row
    q = np.concatenate([keys, _queries(95 + W, keys, 1501)])
    tt = torch.from_numpy(table.view(np.int32))
    want = _truth(keys, q)
    _check(tl.lookup_plain(tt, _t(q), bb, W), want)
    _check(tl.lookup_fused(tt, _t(q), bb, W), want)
    assert want[1][:len(keys)].all() and not want[1].all()
    rows = tl.rows_read(tt, _t(q), bb, W).numpy()
    assert rows.max() >= 3 and rows.max() <= 1 << bb
    # a present key is found in the row where it is stored
    np.testing.assert_array_equal(
        rows[:len(keys)][store], (r - home) % (1 << bb) + 1)


def test_table32_without_an_empty_slot_ends_every_probe():
    keys = _keys(7, 40, 1)[:20]
    table, bb = tl.build_table32(keys, b_bits=1)
    assert bb == 1 and (table[:, :30] != 0xFFFFFFFF).all()
    q = np.concatenate([keys, _keys(8, 50, 1), np.full((3, 1), SENT)])
    tt = torch.from_numpy(table.view(np.int32))
    _check(tl.lookup_plain(tt, _t(q), bb, 1), _truth(keys, q))
    assert int(tl.rows_read(tt, _t(q), bb, 1).max()) == 2


@pytest.mark.parametrize("W", [1, 2])
def test_chained_probe_on_a_crowded_128_lane_table_matches_jax(W):
    """The reference-shaped table filled until rows are full: the probe
    walks on from a full row and still gives JAX's answers."""
    pool = _keys(20 + W, 4000, W)
    S, bb = tl.slots_for(W), 4
    home = (tk.kmer_hash_np(pool) >> np.uint64(64 - bb)).astype(np.int64)
    order = np.argsort(home, kind="stable")
    rank = np.empty(len(pool), np.int64)
    rank[order] = np.arange(len(pool)) - np.searchsorted(home[order],
                                                         home[order])
    keys = pool[(rank < S) & ((home % 3 == 0) | (rank < 20))]
    table, got_b = tl.build_table128(keys, b_bits=bb)
    want_t, want_b = jpl.build_table128(keys, b_bits=bb)
    assert got_b == want_b == bb
    np.testing.assert_array_equal(table, want_t)
    full = (table[:, :S] != 0xFFFFFFFF).all(axis=1)
    assert full[0] and full[15] and not full[1]     # a wrap from the last row
    q = np.concatenate([_queries(25 + W, keys, 1001), pool[::3]])
    want = jpl.lookup_fused(jnp.asarray(want_t), jnp.asarray(q), want_b, W,
                            interpret=True)
    tt = torch.from_numpy(table.view(np.int32))
    _check(tl.lookup_plain(tt, _t(q), bb, W),
           (np.asarray(want[0]), np.asarray(want[1])))
    np.testing.assert_array_equal(np.asarray(want[0]), _truth(keys, q)[0])
    assert int(tl.rows_read(tt, _t(q), bb, W).max()) >= 2


@pytest.mark.parametrize("impl", ["auto", "planar", "fused", "join"])
def test_lookup_under_each_mctx_lookup(monkeypatch, case, impl):
    """The port's one lookup against the JAX package's lookup under each
    of its MCTX_LOOKUP values; the table is memoised on the key tensor
    itself."""
    W, keys, q = case["W"], case["keys"], case["q"]
    padded = np.concatenate([keys, np.full((100, W), SENT)])
    monkeypatch.setattr(jh, "LOOKUP_IMPL", impl)
    if impl == "fused":   # JAX's lookup would run the kernel compiled
        want = case["want"]["fused"]
    else:
        want = jh.lookup(jnp.asarray(padded), jnp.asarray(q))
    kt = _t(padded)
    got = th.lookup(kt, _t(q))
    _check(got, (np.asarray(want[0]), np.asarray(want[1])))
    table, bb = th._tables.peek((kt,), tuple(kt.shape))
    assert table.shape == (1 << bb, tl.ROW32) and table.dtype == torch.int32
    n = len(th._tables)
    assert th.get_index32_for(kt)[0] is table
    assert th.lookup(kt, _t(q))[0].equal(got[0])
    assert len(th._tables) == n
    assert th._tables.peek((kt.clone(),), tuple(kt.shape)) is None


LOOKUP_KINDS = ["live", "padded", "empty", "batch_shape", "many_queries"]


@pytest.mark.parametrize("kind", LOOKUP_KINDS)
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_lookup_matches_jax(W, kind):
    """ops.hashidx.lookup against the JAX package's hashidx.lookup: a live
    store, one with a sentinel tail as the graph phases pass it, an empty
    one, a batch of queries shaped (3, 667, W), and a batch many times
    the store with repeats and sentinel queries."""
    keys = _keys(100 + W, 40 if kind == "many_queries" else 600, W)
    q = _queries(110 + W, keys, 2001)
    if kind == "padded" or kind == "batch_shape":
        keys = np.concatenate([keys, np.full((77, W), SENT)])
    elif kind == "empty":
        keys = keys[:0]
    if kind == "batch_shape":
        q = q.reshape(3, 667, W)
    elif kind == "many_queries":
        rng = np.random.default_rng(120 + W)
        q = np.concatenate([q, keys[rng.integers(0, len(keys), 3000)],
                            np.full((20, W), SENT)])[rng.permutation(5021)]
    want = jh.lookup(jnp.asarray(keys), jnp.asarray(q))
    idx, found = th.lookup(_t(keys), _t(q))
    assert idx.shape == found.shape == q.shape[:-1]
    _check((idx.reshape(-1), found.reshape(-1)),
           (np.asarray(want[0]).reshape(-1), np.asarray(want[1]).reshape(-1)))
    assert bool(found.any()) == (kind != "empty")


@pytest.mark.parametrize("W", [1, 2])
def test_searchsorted_and_lookup_match_jax(W):
    keys = _keys(60 + W, 2000, W)
    padded = np.concatenate([keys, np.full((50, W), SENT)])
    q = _queries(70 + W, keys, 1001).reshape(7, 143, W)
    jk_, jq = jnp.asarray(padded), jnp.asarray(q)
    got = tsops.searchsorted_mw(_t(padded), _t(q))
    assert got.dtype == torch.int32 and got.shape == (7, 143)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsops.searchsorted_mw(jk_, jq)))
    _check(tsops.lookup(_t(padded), _t(q)),
           tuple(np.asarray(x) for x in jsops.lookup(jk_, jq)))
    flat = q.reshape(-1, W)
    # JAX's multiword side="right" search steps once past the end for a
    # query that is not below the last key (here: the sentinel queries
    # against the sentinel tail); the port gives M there, as both give at
    # W = 1.  Everywhere else the two are equal.
    below_last = ~(flat == SENT).all(axis=1)
    for side in ("left", "right"):
        got = tsops.searchsorted_chunked(_t(padded), _t(flat), side).numpy()
        want = np.asarray(jsops.searchsorted_chunked(
            jk_, jnp.asarray(flat), side))
        np.testing.assert_array_equal(got[below_last], want[below_last])
        np.testing.assert_array_equal(
            got[~below_last],
            len(keys) if side == "left" else len(padded))
    with pytest.raises(ValueError):
        tsops.searchsorted_chunked(_t(padded), _t(flat), "middle")


def test_lookup_fused_checks_its_arguments():
    keys = _keys(2, 100, 1)
    table, bb = tl.build_table128(keys)
    tt = torch.from_numpy(table.view(np.int32))
    with pytest.raises(ValueError, match="table"):
        tl.lookup_fused(tt, _t(keys), bb + 1, 1)
    with pytest.raises(ValueError, match="table"):
        tl.lookup_fused(tt.to(torch.int64), _t(keys), bb, 1)
    with pytest.raises(ValueError, match="table"):
        tl.lookup_fused(tt[:1], _t(keys), 0, 1)
    with pytest.raises(ValueError, match="queries"):
        tl.lookup_fused(tt, _t(keys).to(torch.int32), bb, 1)
    with pytest.raises(ValueError, match="queries"):
        tl.lookup_fused(tt, _t(keys), bb, 2)
    with pytest.raises(ValueError, match="table"):
        tl.lookup_fused(tt[:, :64].contiguous(), _t(keys), bb, 1)
    t32, b32 = tl.build_table32(keys)
    with pytest.raises(ValueError, match="table"):
        tl.lookup_fused(torch.from_numpy(t32.view(np.int32)), _t(keys),
                        b32 - 1, 1)
    idx, found = tl.lookup_fused(tt, _t(keys[:0]), bb, 1)
    assert idx.shape == found.shape == (0,)


@pytest.mark.parametrize("k,W", [(5, 1), (31, 1), (33, 2), (63, 2)])
def test_kmers_to_strings_copy(k, W):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 2**64, size=(200, W), dtype=np.uint64)
    keys[:, 0] &= np.uint64((1 << (2 * k - 64 * (W - 1))) - 1)
    assert ttext.kmers_to_strings(keys, k) == jtext.kmers_to_strings(keys, k)


@pytest.mark.parametrize("W,C", [(1, 1), (1, 3), (2, 2)])
def test_from_records_matches_jax(W, C):
    rng = np.random.default_rng(W * 10 + C)
    pool = _keys(W + C, 400, W)
    keys = pool[rng.integers(0, len(pool), 1500)]
    keys[rng.random(1500) < 0.05] = SENT
    covg = rng.integers(0, 2**32, size=(1500, C), dtype=np.uint64).astype(
        np.uint32)
    edges = rng.integers(0, 256, size=(1500, C)).astype(np.uint8)
    jg = jstore.from_records(31 if W == 1 else 33, jnp.asarray(keys),
                             jnp.asarray(covg), jnp.asarray(edges))
    tg = tstore.from_records(31 if W == 1 else 33, _t(keys),
                             torch.from_numpy(covg.view(np.int32)),
                             torch.from_numpy(edges))
    assert tg.n == int(jg.n) and tg.capacity == jg.capacity
    np.testing.assert_array_equal(_u64(tg.keys), np.asarray(jg.keys))
    np.testing.assert_array_equal(tg.covg.numpy().view(np.uint32),
                                  np.asarray(jg.covg))
    np.testing.assert_array_equal(tg.edges.numpy(), np.asarray(jg.edges))
    # union edges, memoised on the edges tensor
    ue = tstore.cached_union_edges(tg)
    np.testing.assert_array_equal(ue.numpy(),
                                  np.asarray(jstore.union_edges(jg)))
    assert tstore.cached_union_edges(tg) is ue
    # store lookup of its own live keys finds every row
    idx, found = tstore.lookup(tg, tg.keys[:tg.n])
    assert bool(found.all())
    np.testing.assert_array_equal(idx.numpy(), np.arange(tg.n))


def test_edge_helpers_match_jax():
    rng = np.random.default_rng(9)
    e = rng.integers(0, 256, size=(500, 3)).astype(np.uint8)
    o = rng.integers(0, 2, 500).astype(np.uint8)
    nuc = rng.integers(0, 4, 500).astype(np.uint8)
    je, jo, jn = jnp.asarray(e[:, 0]), jnp.asarray(o), jnp.asarray(nuc)
    te, to, tn = (torch.from_numpy(e[:, 0]), torch.from_numpy(o),
                  torch.from_numpy(nuc))
    pairs = [
        (tedges.edge_bit(tn, to), jedges.edge_bit(jn, jo)),
        (tedges.with_orientation(te, to), jedges.with_orientation(je, jo)),
        (tedges.outdegree(te, to), jedges.outdegree(je, jo)),
        (tedges.indegree(te, to), jedges.indegree(je, jo)),
        (tedges.has_edge(te, tn, to), jedges.has_edge(je, jn, jo)),
        (tedges.as_fw_nibble(te, to), jedges.as_fw_nibble(je, jo)),
        (tedges.union_colours(torch.from_numpy(e)),
         jedges.union_colours(jnp.asarray(e))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

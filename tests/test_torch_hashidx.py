"""The port's lookup layer (ops.kmer hashing, ops.hashidx, the lookup
kernel's plain version, ops.sorted.lookup_join, graph.store and
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


@pytest.fixture(scope="module", params=[1, 2], ids=["W1", "W2"])
def case(request):
    """A store, its queries and JAX's answers through every lookup."""
    W = request.param
    keys = _keys(40 + W, 3000, W)
    q = _queries(50 + W, keys, 2001)
    t128, b128 = jpl.build_table128(keys)
    tplan, bplan = jh.build_table(keys)
    want = {
        "fused": jpl.lookup_fused(jnp.asarray(t128), jnp.asarray(q), b128,
                                  W, interpret=True),
        "planar": jh.lookup_planar(jnp.asarray(tplan), jnp.asarray(q),
                                   bplan, W),
        "join": jsops.lookup_join(jnp.asarray(keys), jnp.asarray(q)),
    }
    want = {k: (np.asarray(i), np.asarray(f)) for k, (i, f) in want.items()}
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
    np.testing.assert_array_equal(th._hash_np(keys), jh._hash_np(keys))
    np.testing.assert_array_equal(got, th._hash_np(keys))
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
    """Both tables, including the overflow retry from a b_bits that is
    far too small."""
    keys = _keys(60 + W, 4000, W)
    for got, want in ((th.build_table(keys, b_bits),
                       jh.build_table(keys, b_bits)),
                      (tl.build_table128(keys, b_bits=b_bits),
                       jpl.build_table128(keys, b_bits=b_bits))):
        assert got[1] == want[1]
        assert got[0].dtype == want[0].dtype == np.uint32
        np.testing.assert_array_equal(got[0], want[0])
    table, bb = tl.build_table128(keys, b_bits=b_bits)
    assert table.shape == (1 << bb, 128)


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


def test_lookup_planar_and_join_match_jax(case):
    W, keys, q = case["W"], case["keys"], case["q"]
    table, bb = th.build_table(keys)
    _check(th.lookup_planar(torch.from_numpy(table.view(np.int32)), _t(q),
                            bb, W), case["want"]["planar"])
    _check(tsops.lookup_join(_t(keys), _t(q)), case["want"]["join"])
    # a sentinel-padded store, as the graph phases pass it
    padded = np.concatenate([keys, np.full((77, W), SENT)])
    _check(tsops.lookup_join(_t(padded), _t(q)), case["want"]["join"])
    for impl in ("planar", "join"):
        np.testing.assert_array_equal(case["want"][impl][0],
                                      case["want"]["fused"][0])


@pytest.mark.parametrize("impl", ["auto", "planar", "fused", "join"])
def test_lookup_under_each_mctx_lookup(monkeypatch, case, impl):
    W, keys, q = case["W"], case["keys"], case["q"]
    padded = np.concatenate([keys, np.full((100, W), SENT)])
    monkeypatch.setattr(th, "LOOKUP_IMPL", impl)
    monkeypatch.setattr(jh, "LOOKUP_IMPL", impl)
    if impl == "fused":   # JAX's lookup would run the kernel compiled
        want = case["want"]["fused"]
    else:
        want = jh.lookup(jnp.asarray(padded), jnp.asarray(q))
    kt = _t(padded)
    got = th.lookup(kt, _t(q))
    _check(got, (np.asarray(want[0]), np.asarray(want[1])))
    # the table is cached on the key tensor itself
    if impl in ("fused", "planar"):
        cache = th._cache128 if impl == "fused" else th._cache_store
        hit = cache[(id(kt), tuple(kt.shape))]
        assert hit[0] is kt
        assert th.lookup(kt, _t(q))[0].equal(got[0])
        assert len([v for v in cache.values() if v[0] is kt]) == 1


def test_lookup_chunks_large_batches(monkeypatch, case):
    W, keys, q = case["W"], case["keys"], case["q"]
    monkeypatch.setattr(th, "HCHUNK", 512)
    for impl in ("planar", "join"):
        monkeypatch.setattr(th, "LOOKUP_IMPL", impl)
        _check(th.lookup(_t(keys), _t(q)), case["want"]["fused"])


def test_pick_impl_gate(monkeypatch):
    monkeypatch.setattr(th, "LOOKUP_IMPL", "auto")
    monkeypatch.setattr(jh, "LOOKUP_IMPL", "auto")
    # a CUDA store takes the kernel whatever the shapes
    for n, nq in ((10, 10), (1 << 20, 1 << 22), (100 << 20, 1)):
        assert th._pick_impl(n, nq, "cuda") == "fused"
        assert th._pick_impl(n, nq, torch.device("cuda", 0)) == "fused"
    # the CPU keeps the JAX package's gate
    for n, nq in ((10, 10), (1 << 20, 1 << 21), (3 << 20, 1 << 20),
                  (1 << 21, 1 << 23), (40 << 20, 1 << 23), (0, 1 << 20)):
        assert th._pick_impl(n, nq) == jh._pick_impl(n, nq)
    assert th._pick_impl(1 << 20, 1 << 21) == "join"
    monkeypatch.setattr(th, "LOOKUP_IMPL", "planar")
    assert th._pick_impl(5, 5, "cuda") == "planar"
    monkeypatch.setattr(th, "LOOKUP_IMPL", "bogus")
    with pytest.raises(ValueError, match="MCTX_LOOKUP"):
        th._pick_impl(5, 5)


def test_lookup_join_mp_is_not_ported():
    keys = _t(_keys(1, 10, 1))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tsops.lookup_join(keys, keys, variant="mp")


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

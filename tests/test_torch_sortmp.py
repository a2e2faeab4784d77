"""The port's merge level, merge-path sort and sort engines (plain
versions, which CPU tensors take, at small tiles) against the JAX
package's Pallas kernels in interpret mode at a small block, and against
numpy stable sorts.

sort_planes_mp and merge_level are stable: every plane equals numpy's
stable lexsort.  The JAX kernels are not, so against them the key planes
must match element for element and whole records as a multiset.  The
build functions (count_batch, reduce_records_fused, merge_sorted_fused)
aggregate equal keys, so their outputs are equal exactly under every
engine.  Integer outputs: exact equality, no tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import build as jb
from mccortex_tpu.ops.pallas import bitonic as jbt
from mccortex_tpu.ops.pallas import mergepath as jmp
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.ops.kernels import mergepath as tmp

R_TEST = 8
BLK_TEST = R_TEST * jbt.LANES
TILE = 64                          # the port's plain versions' tile here
ENGINES = ("lax", "lax64", "mp", "bitonic")


@pytest.fixture(scope="module", autouse=True)
def small_blocks():
    """The JAX package's Pallas sorts at 1024-record blocks."""
    saved = (jbt.R_BLK, jbt.BLK, jmp._r_blk_for)
    jbt.R_BLK, jbt.BLK = R_TEST, BLK_TEST
    jmp._r_blk_for = lambda np_: R_TEST
    jax.clear_caches()
    yield
    jbt.R_BLK, jbt.BLK, jmp._r_blk_for = saved
    jax.clear_caches()


def _planes(rng, M, np_, nk, dup=False, sent_frac=0.0):
    hi = 7 if dup else 2**32
    keys = rng.integers(0, hi, size=(nk, M), dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=(np_ - nk, M),
                        dtype=np.uint64).astype(np.uint32)
    keys[:, rng.random(M) < sent_frac] = 0xFFFFFFFF
    return np.concatenate([keys, vals])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


def _stable(planes, nk):
    return planes[:, np.lexsort(planes[:nk][::-1])]


def _by_record(planes):
    return planes[:, np.lexsort(planes[::-1])]


def _jnp(planes):
    return tuple(jnp.asarray(p) for p in planes)


def _np(out):
    return np.stack([np.asarray(x) for x in out])


# ---------------------------------------------------------------------------
# merge level and sort_planes_mp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,R,np_,nk", [
    (64, 16, 3, 2), (64, 32, 3, 2), (100, 16, 4, 2), (33, 16, 2, 1),
    (16, 16, 3, 2), (7, 16, 3, 3), (1000, 8, 6, 4), (48, 16, 3, 2)])
def test_merge_level_is_the_stable_merge_of_run_pairs(M, R, np_, nk):
    rng = np.random.default_rng(M * R)
    planes = _planes(rng, M, np_, nk, dup=True, sent_frac=0.1)
    want = planes.copy()
    for s in range(0, M, R):
        planes[:, s:s + R] = _stable(planes[:, s:s + R], nk)
    for s in range(0, M, 2 * R):
        want[:, s:s + 2 * R] = _stable(planes[:, s:s + 2 * R], nk)
    got = _u(tmp.merge_level(_t(planes), nk, R))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,np_,nk,tile,dup", [
    (1, 3, 2, 16, False), (15, 3, 2, 16, True), (17, 3, 2, 16, True),
    (3 * 16 + 17, 4, 2, 16, True), (5000, 5, 4, 64, False),
    (4096, 2, 1, 256, True), (777, 12, 8, 32, True)])
def test_sort_planes_mp_is_a_stable_sort(M, np_, nk, tile, dup):
    rng = np.random.default_rng(M + nk)
    planes = _planes(rng, M, np_, nk, dup=dup, sent_frac=0.1)
    got = _u(tmp.sort_planes_mp(_t(planes), nk, tile=tile))
    np.testing.assert_array_equal(got, _stable(planes, nk))


@pytest.mark.parametrize("case", ["random", "all_equal", "heavy_dup",
                                  "sentinel_padded"])
def test_sort_planes_mp_matches_jax(case):
    rng = np.random.default_rng(len(case))
    np_, nk = 3, 2
    M = 4 * BLK_TEST                # blk * 2**j: the JAX kernel's rule
    planes = _planes(rng, M, np_, nk, dup=case == "heavy_dup")
    if case == "all_equal":
        planes[:nk] = 0xABCD1234
    if case == "sentinel_padded":
        planes[:nk, M - 900:] = 0xFFFFFFFF
        planes[nk:, M - 900:] = 0
    want = _np(jmp.sort_planes_mp(_jnp(planes), num_keys=nk, interpret=True))
    got = _u(tmp.sort_planes_mp(_t(planes), nk, tile=TILE))
    np.testing.assert_array_equal(got[:nk], want[:nk])
    np.testing.assert_array_equal(_by_record(got), _by_record(want))
    np.testing.assert_array_equal(got, _stable(planes, nk))


def test_merge_level_rejects_bad_arguments():
    x = torch.zeros((3, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        tmp.merge_level(x, 4, 4)
    with pytest.raises(ValueError):
        tmp.merge_level(x, 2, 0)
    with pytest.raises(ValueError):
        tmp.merge_level(x.to(torch.int64), 2, 4)
    assert tmp.merge_level(x[:, :0], 2, 4).shape == (3, 0)


# ---------------------------------------------------------------------------
# the sort engines of the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ENGINES)
def test_sort_planes32_matches_jax(impl):
    rng = np.random.default_rng(21)
    np_, nk, M = 3, 2, 2 * BLK_TEST + 300       # ragged: mp and bitonic pad
    planes = _planes(rng, M, np_, nk, dup=True, sent_frac=0.05)
    planes[nk:, (planes[:nk] == 0xFFFFFFFF).all(axis=0)] = 0
    want = _np(jb._sort_planes32(_jnp(planes), nk, impl, interpret=True))
    got = _u(tb._sort_planes32(_t(planes), nk, impl, tile=TILE))
    assert got.shape[1] >= M and want.shape[1] >= M
    got, want = got[:, :M], want[:, :M]         # the live prefix
    np.testing.assert_array_equal(got[:nk], want[:nk])
    np.testing.assert_array_equal(_by_record(got), _by_record(want))
    np.testing.assert_array_equal(got[:nk], _stable(planes, nk)[:nk])


def test_unknown_engine_raises():
    x = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        tb._sort_planes32(x, 2, "quick")
    with pytest.raises(ValueError):
        tb.count_batch(torch.zeros((2, 20), dtype=torch.uint8), 5, 1, 0,
                       sort_impl="quick")


def _bases(k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, size=(16, 3 * k + 19), dtype=np.uint8)
    bases[rng.random(bases.shape) < 0.01] = 4
    bases[:, :2 * k] = bases[0, :2 * k]         # duplicate windows
    return bases


_JAX_EPOCH = {}


def _jax_count_batch(k, impl):
    if (k, impl) not in _JAX_EPOCH:
        out = jb.count_batch_fused(jnp.asarray(_bases(k)), k, 2, 1,
                                   interpret=True, sort_impl=impl)
        _JAX_EPOCH[k, impl] = [np.asarray(x) for x in out]
    return _JAX_EPOCH[k, impl]


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("k", [15, 31, 63])
def test_count_batch_per_engine_matches_jax(k, impl):
    # the JAX side runs the same engine at k = 15 and lax above it
    jk, jc, je, jn = _jax_count_batch(k, impl if k == 15 else "lax")
    tk, tc, te, tn = tb.count_batch(torch.from_numpy(_bases(k)), k, 2, 1,
                                    sort_impl=impl, tile=TILE)
    n = int(jn)
    assert tn == n > 0
    assert tk.shape == jk.shape
    np.testing.assert_array_equal(tk.numpy().view(np.uint64), jk)
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), jc)
    np.testing.assert_array_equal(te.numpy(), je)


def _item(rng, n, cap, W, C):
    """A sorted, unique, sentinel-padded record array of capacity cap."""
    keys = np.unique(rng.integers(0, 1 << 20, size=(n, W), dtype=np.uint64),
                     axis=0)
    m = len(keys)
    ko = np.full((cap, W), np.uint64(2**64 - 1))
    ko[:m] = keys
    co = np.zeros((cap, C), np.uint32)
    co[:m] = rng.integers(1, 100, size=(m, C))
    eo = np.zeros((cap, C), np.uint8)
    eo[:m] = rng.integers(0, 256, size=(m, C))
    return ko, co, eo


def _to_torch(k, c, e):
    return (torch.from_numpy(k.view(np.int64)),
            torch.from_numpy(c.view(np.int32)), torch.from_numpy(e))


def _records_equal(got, want):
    tk, tc, te, tn = got
    jk, jc, je, jn = want
    assert tn == int(jn)
    np.testing.assert_array_equal(tk.numpy().view(np.uint64), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("impl", ["lax", "mp", "bitonic"])
@pytest.mark.parametrize("W,C", [(1, 1), (2, 2)])
def test_merge_sorted_fused_per_engine_matches_jax(W, C, impl):
    rng = np.random.default_rng(10 * W + C)
    a = _item(rng, 700, 1024, W, C)
    b = _item(rng, 1100, 2048, W, C)
    b[0][:300] = a[0][:300]                     # shared keys
    order = np.lexsort(b[0].T[::-1])
    b = tuple(x[order] for x in b)
    want = jb.merge_sorted_fused(*(jnp.asarray(x) for x in a + b),
                                 interpret=True, sort_impl=impl)
    got = tb.merge_sorted_fused(*_to_torch(*a), *_to_torch(*b),
                                sort_impl=impl, tile=TILE)
    _records_equal(got, want)
    assert got[3] < 700 + 1100


@pytest.mark.parametrize("impl", ENGINES)
def test_reduce_records_fused_per_engine_matches_jax(impl):
    rng = np.random.default_rng(33)
    W, C, M = 2, 2, 1500
    keys = rng.integers(0, 40, size=(M, W), dtype=np.uint64)
    keys[rng.random(M) < 0.1] = np.uint64(2**64 - 1)
    live = ~(keys == np.uint64(2**64 - 1)).all(axis=1)
    covg = rng.integers(0, 2**32, size=(M, C), dtype=np.uint64).astype(
        np.uint32) * live[:, None]
    edges = rng.integers(0, 256, size=(M, C)).astype(np.uint8) * live[:, None]
    want = jb.reduce_records_fused(jnp.asarray(keys), jnp.asarray(covg),
                                   jnp.asarray(edges), interpret=True,
                                   sort_impl=impl)
    got = tb.reduce_records_fused(*_to_torch(keys, covg, edges),
                                  sort_impl=impl, tile=TILE)
    _records_equal(got, want)

"""The port's segreduce (plain version, which CPU tensors take) against
the Pallas kernel mccortex_tpu.ops.pallas.segreduce.
segreduce_compact_multi in interpret mode, and the port's
ops.sorted.unique_reduce against mccortex_tpu.ops.sorted.unique_reduce.
Integer outputs: exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.ops import sorted as jsops
from mccortex_tpu.ops.pallas import segreduce as jsr
from mccortex_tpu_torch.ops import sorted as tsops
from mccortex_tpu_torch.ops.kernels import segreduce as tsr


def _sorted_keys(rng, M, NK, n_unique, sent_frac):
    """(NK, M) int32 key planes: n_unique random keys repeated, sorted
    unsigned-lexicographically, then a sentinel tail."""
    n_sent = int(M * sent_frac)
    pool = rng.integers(0, 2**32, size=(n_unique, NK), dtype=np.uint64)
    rows = pool[rng.integers(0, n_unique, M - n_sent)].astype(np.uint32)
    rows = rows[np.lexsort(rows.T[::-1])]
    rows = np.concatenate([rows, np.full((n_sent, NK), 0xFFFFFFFF,
                                         np.uint32)])
    return np.ascontiguousarray(rows.T).view(np.int32)


def _case(name, M):
    rng = np.random.default_rng(CASES.index(name) * 1000 + M)
    NK, NS, NO = 1, 0, 1
    if name == "heavy_dup":
        keys = _sorted_keys(rng, M, 1, 7, 0.2)
    elif name == "all_sentinel":
        keys = np.full((1, M), -1, np.int32)
    elif name == "no_sentinel_tail":
        keys = _sorted_keys(rng, M, 1, M // 3, 0.0)
    elif name == "run_at_block_edge":
        # one run over the last records of the first 32768-record block
        # (and, at M=65536, into the second): setting a sorted slice to
        # its first value keeps the planes sorted
        keys = _sorted_keys(rng, M, 1, M // 2, 0.0)
        keys[0, 32760:32780] = keys[0, 32760]
    elif name == "two_key_planes":
        NK = 2
        keys = _sorted_keys(rng, M, 2, M // 4, 0.25)
    elif name == "sums_and_ors":
        NK, NS, NO = 2, 2, 2
        keys = _sorted_keys(rng, M, 2, M // 8, 0.1)
    else:
        raise AssertionError(name)
    sums = rng.integers(0, 2**31, size=(NS, M)).astype(np.int32)
    ors = rng.integers(0, 256, size=(NO, M)).astype(np.int32)
    return keys, sums, ors


CASES = ["heavy_dup", "all_sentinel", "no_sentinel_tail",
         "run_at_block_edge", "two_key_planes", "sums_and_ors"]


_JAX_CASES = {}


def _jax_case(name, M):
    """A case and the Pallas kernel's result on it (interpret mode),
    computed once for the tests of this file."""
    if (name, M) not in _JAX_CASES:
        keys, sums, ors = _case(name, M)
        out = jsr.segreduce_compact_multi(
            tuple(jnp.asarray(x) for x in keys),
            tuple(jnp.asarray(x) for x in sums),
            tuple(jnp.asarray(x) for x in ors), interpret=True)
        _JAX_CASES[name, M] = (keys, sums, ors), out
    return _JAX_CASES[name, M]


@pytest.mark.parametrize("M", [32768, 65536])
@pytest.mark.parametrize("name", CASES)
def test_matches_pallas_kernel(name, M):
    (keys, sums, ors), (jk, jc, js, jo, jn) = _jax_case(name, M)
    tk, tc, ts, to, tn = tsr.segreduce_compact_multi(
        torch.from_numpy(keys), torch.from_numpy(sums),
        torch.from_numpy(ors))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tk.numpy(), np.stack(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for got, want in ((ts, js), (to, jo)):
        assert got.shape[0] == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_planes_match_pallas_kernel(name, count):
    """segreduce_planes: the Pallas kernel's outputs as one tensor of
    planes (keys, the count only with count=True, sums, ors)."""
    (keys, sums, ors), (jk, jc, js, jo, jn) = _jax_case(name, 32768)
    planes, n = tsr.segreduce_planes(torch.from_numpy(keys),
                                     torch.from_numpy(sums),
                                     torch.from_numpy(ors), count=count)
    want = [np.asarray(x) for x in jk] + ([np.asarray(jc)] if count else []) \
        + [np.asarray(x) for x in js] + [np.asarray(x) for x in jo]
    assert int(n) == int(jn)
    assert planes.dtype == torch.int32 and planes.shape == (len(want), 32768)
    np.testing.assert_array_equal(planes.numpy(), np.stack(want))


def test_planes_of_a_record_tensor_and_without_value_planes():
    """Key, sum and or planes as row views of one record tensor (the
    build's layout), and keys alone with and without the count."""
    (keys, sums, ors), (jk, jc, js, jo, jn) = _jax_case("sums_and_ors", 32768)
    rec = torch.from_numpy(np.concatenate([keys, sums, ors]))
    planes, n = tsr.segreduce_planes(rec[:2], rec[2:4], rec[4:], count=False)
    np.testing.assert_array_equal(
        planes.numpy(), np.stack([np.asarray(x) for x in (*jk, *js, *jo)]))
    for count in (True, False):
        planes, n = tsr.segreduce_planes(rec[:2], count=count)
        assert planes.shape == (2 + count, 32768) and int(n) == int(jn)
        np.testing.assert_array_equal(planes[:2].numpy(), np.stack(jk))
        if count:
            np.testing.assert_array_equal(planes[2].numpy(), np.asarray(jc))


def test_scratch_generations(monkeypatch):
    """The look-back's descriptors are zeroed only when allocated (and
    after GEN_LIMIT calls); every call takes a newer generation, and a
    larger call grows the buffers."""
    monkeypatch.setattr(tsr, "GEN_LIMIT", 4)
    s = tsr._Scratch(torch.device("cpu"))
    desc, extra, gen = s.take(10, 40)
    assert gen == 1 and desc.shape == (10, 4) and extra.numel() >= 40
    desc[:] = 7
    assert s.take(5, 10)[2] == 2 and int(s.desc[0, 0]) == 7
    assert s.take(10, 80)[2] == 3 and s.extra.numel() >= 80
    desc, _extra, gen = s.take(10, 80)      # the generation wraps: zeroed
    assert gen == 1 and int(desc.abs().sum()) == 0
    desc, _extra, gen = s.take(25, 10)      # more tiles: new zeroed words
    assert gen == 1 and desc.shape[0] >= 25 and int(desc.abs().sum()) == 0


@pytest.mark.parametrize("W,C", [(1, 1), (2, 3)])
def test_unique_reduce_matches_jax(W, C):
    rng = np.random.default_rng(40 + W + C)
    N = 5000
    keys = rng.integers(0, 2**64, size=(600, W), dtype=np.uint64)[
        rng.integers(0, 600, N - 500)]
    keys = keys[np.lexsort(keys.T[::-1])]
    keys = np.concatenate([keys, np.full((500, W), 2**64 - 1, np.uint64)])
    covg = rng.integers(0, 2**32, size=(N, C), dtype=np.uint64).astype(
        np.uint32)
    edges = rng.integers(0, 256, size=(N, C)).astype(np.uint8)
    want = jsops.unique_reduce(jnp.asarray(keys), jnp.asarray(covg),
                               jnp.asarray(edges), N)
    got = tsops.unique_reduce(torch.from_numpy(keys.view(np.int64)),
                              torch.from_numpy(covg.view(np.int32)),
                              torch.from_numpy(edges), N)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


def test_sort_by_key_matches_lexsort():
    rng = np.random.default_rng(77)
    keys = rng.integers(0, 2**64, size=(3000, 3), dtype=np.uint64)
    keys[::2, 0] = keys[1::2, 0]                       # ties on word 0
    vals = torch.arange(3000)
    sk, sv = tsops.sort_by_key(torch.from_numpy(keys.view(np.int64)), vals)
    order = np.lexsort(keys.T[::-1])                   # stable
    np.testing.assert_array_equal(sk.numpy().view(np.uint64), keys[order])
    np.testing.assert_array_equal(sv.numpy(), order)

"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked `gpu`: without a CUDA device every test skips.  Imports no
jax, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Integer outputs: exact equality, no tolerance.
"""

import numpy as np
import pytest
import torch

from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.ops import sorted as sops
from mccortex_tpu_torch.ops import hashidx
from mccortex_tpu_torch.ops.kernels import _build, bitonic, frontend, lookup
from mccortex_tpu_torch.ops.kernels import mergepath, segreduce

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reads(seed, B, L):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.02] = 4
    bases[0, L // 3:] = 4
    return torch.from_numpy(bases)


@pytest.mark.parametrize("k,B,L", [(11, 33, 90), (31, 300, 150),
                                   (33, 50, 151), (63, 64, 250),
                                   (31, 5, 20), (21, 3, 3000), (32, 40, 100),
                                   (3, 7, 151), (11, 2, frontend.MAX_L)])
def test_frontend_kernel_matches_plain(cuda, k, B, L):
    bases = _reads(k * B + L, B, L).to(cuda)
    n0 = _build.LAUNCHES["frontend"]
    got = frontend.records_fused(bases, k)
    assert _build.LAUNCHES["frontend"] == n0 + 1
    want = frontend.records_plain(bases, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _reads_with_n_at_the_ends(seed, B, L):
    """Reads with N at the first base, the last base and inside."""
    bases = _reads(seed, B, L)
    bases[0, 0] = 4
    bases[min(1, B - 1), L - 1] = 7
    bases[-1, L // 2] = 4
    return bases


@pytest.mark.parametrize("k", [3, 11, 31, 32, 33, 63])
@pytest.mark.parametrize("L", ["1", "k-1", "k", "20", "150", "151", "3000"])
def test_records_epoch_kernel_matches_plain(cuda, k, L):
    L = {"k-1": k - 1, "k": k}.get(L) or int(L)
    B = 3 if L >= 3000 else 40
    bases = _reads_with_n_at_the_ends(k * 7 + L, B, L).to(cuda)
    n0 = _build.LAUNCHES["frontend"]
    got = frontend.records_epoch(bases, k)
    assert _build.LAUNCHES["frontend"] == n0 + 1
    want = frontend.records_epoch_plain(bases, k)
    assert got.shape == (2 * (1 if k <= 32 else 2) + 1,
                         B * frontend.epoch_windows(L, k))
    assert torch.equal(got, want)
    for g, w in zip(frontend.records_fused(bases, k),
                    frontend.records_plain(bases, k)):
        assert torch.equal(g, w)


def test_records_epoch_of_empty_rows(cuda):
    bases = torch.zeros((5, 0), dtype=torch.uint8, device=cuda)
    got = frontend.records_epoch(bases, 31)
    assert torch.equal(got, frontend.records_epoch_plain(bases, 31))
    assert got.shape == (3, 5) and bool((got[:2] == -1).all())


def _sorted_keys(rng, M, NK, n_unique, sent_frac):
    pool = rng.integers(0, 2**32, size=(n_unique, NK), dtype=np.uint64)
    n_sent = int(M * sent_frac)
    rows = pool[rng.integers(0, n_unique, M - n_sent)].astype(np.uint32)
    rows = rows[np.lexsort(rows.T[::-1])]
    rows = np.concatenate([rows, np.full((n_sent, NK), 0xFFFFFFFF,
                                         np.uint32)])
    return torch.from_numpy(np.ascontiguousarray(rows.T).view(np.int32))


@pytest.mark.parametrize("M,NK,NS,NO,n_unique,sent", [
    (1, 1, 0, 1, 1, 0.0), (1000, 2, 0, 1, 50, 0.2), (70000, 2, 2, 2, 3, 0.0),
    (5000, 4, 1, 0, 5000, 0.5), (4096, 2, 0, 1, 10, 1.0),
    (300000, 2, 0, 1, 100000, 0.1)])
def test_segreduce_kernel_matches_plain(cuda, M, NK, NS, NO, n_unique, sent):
    rng = np.random.default_rng(M + NK)
    keys = _sorted_keys(rng, M, NK, n_unique, sent).to(cuda)
    sums = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NS, M))
                            .astype(np.int32)).to(cuda)
    ors = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NO, M))
                           .astype(np.int32)).to(cuda)
    got = segreduce.segreduce_compact_multi(keys, sums, ors)
    want = segreduce.segreduce_plain(keys, sums, ors)
    assert int(got[4]) == int(want[4])
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)


TILE = segreduce.TILE


@pytest.mark.parametrize("label,M,nk,ns,no,count,n_unique,sent", [
    ("one record", 1, 2, 0, 1, 1, 1, 0.0),
    ("ragged tiles", 3 * TILE + 77, 2, 0, 1, 1, 900, 0.1),
    ("heavy duplicates", 4 * TILE + 5, 2, 1, 1, 0, 6, 0.0),
    ("run over five tiles", 6 * TILE, 1, 1, 1, 1, 0, 0.0),
    ("tiles without a start", 5 * TILE + 3, 2, 2, 2, 1, 2, 0.05),
    ("all sentinels", 2 * TILE + 9, 2, 1, 1, 1, 1, 1.0),
    ("four key planes, -1 planes", 3 * TILE, 4, 1, 0, 1, 400, 0.2),
    ("wrapping sums", 2 * TILE + 1, 1, 3, 0, 0, 3, 0.0),
    ("no value planes", 2 * TILE, 2, 0, 0, 0, 700, 0.3),
    ("keys only, count", 3 * TILE + 1, 3, 0, 0, 1, 1000, 0.0),
    ("three key planes, an epoch", 120 * TILE, 3, 1, 1, 0, 40000, 0.1),
    ("six key planes", 3 * TILE + 17, 6, 1, 1, 0, 300, 0.1),
    ("five key planes, 33 planes", TILE + 31, 5, 20, 13, 1, 50, 0.1),
    ("run over 300 tiles", 400 * TILE + 3, 2, 1, 1, 0, 0, 0.0),
    ("many tiles", 1_000_003, 2, 1, 1, 1, 300_000, 0.1),
    ("merge shape", 1 << 23, 2, 1, 1, 0, 1 << 21, 0.1)])
def test_segreduce_planes_kernel_matches_plain(cuda, label, M, nk, ns, no,
                                               count, n_unique, sent):
    rng = np.random.default_rng(M + nk + ns)
    if n_unique:
        keys = _sorted_keys(rng, M, nk, n_unique, sent)
    else:                            # one key over most of the tiles
        keys = _sorted_keys(rng, M, nk, M // 4, 0.0)
        keys[:, 500:M - 200] = keys[:, 500:501].clone()
        keys = keys[:, sops.argsort_planes(keys)]
    if nk == 4:                      # live keys with -1 planes
        keys[:2, :M // 3] = -1
        keys = keys[:, sops.argsort_planes(keys)]
    lo, hi = (2**31 - 3, 2**31) if "wrap" in label else (-2**31, 2**31)
    sums = torch.from_numpy(rng.integers(lo, hi, size=(ns, M))
                            .astype(np.int32)).to(cuda)
    ors = torch.from_numpy(rng.integers(-2**31, 2**31, size=(no, M))
                           .astype(np.int32)).to(cuda)
    keys = keys.contiguous().to(cuda)
    n0 = _build.LAUNCHES["segreduce"]
    got, n = segreduce.segreduce_planes(keys, sums if ns else None,
                                        ors if no else None, bool(count))
    assert _build.LAUNCHES["segreduce"] == n0 + 1
    want, wn = segreduce.segreduce_planes_plain(keys, sums, ors, bool(count))
    assert int(n) == int(wn)
    assert got.shape == (nk + count + ns + no, M) and torch.equal(got, want)


def test_segreduce_planes_on_row_views_of_one_tensor(cuda):
    """Key, sum and or planes as row slices of one record tensor (the
    build's layout), twice on one stream: the second call reuses the
    scratch under a newer generation."""
    rng = np.random.default_rng(5)
    for M, n_unique in ((70000, 2000), (5000, 4999)):
        keys = _sorted_keys(rng, M, 2, n_unique, 0.2)
        vals = torch.from_numpy(rng.integers(0, 256, size=(2, M))
                                .astype(np.int32))
        rec = torch.cat([keys, vals]).to(cuda)
        got, n = segreduce.segreduce_planes(rec[:2], rec[2:3], rec[3:],
                                            count=False)
        want, wn = segreduce.segreduce_planes_plain(rec[:2], rec[2:3],
                                                    rec[3:], False)
        assert int(n) == int(wn) and torch.equal(got, want)


@pytest.mark.parametrize("Ma,Mb,np_,nk,hi", [
    (3000, 2500, 4, 2, 2**32), (5000, 10, 3, 1, 50), (0, 1500, 2, 2, 2**32),
    (2048, 2048, 6, 4, 3), (100003, 70001, 4, 2, 1000)])
def test_mergepath_kernel_matches_plain(cuda, Ma, Mb, np_, nk, hi):
    rng = np.random.default_rng(Ma + Mb + nk)

    def side(M):
        keys = rng.integers(0, hi, size=(nk, M), dtype=np.uint64).astype(
            np.uint32)
        keys = keys[:, np.lexsort(keys[::-1])]
        vals = rng.integers(0, 2**32, size=(np_ - nk, M), dtype=np.uint64
                            ).astype(np.uint32)
        return torch.from_numpy(np.concatenate([keys, vals]).view(np.int32)
                                ).to(cuda)

    a, b = side(Ma), side(Mb)
    got = mergepath.merge_path_planes(a, b, nk)
    assert torch.equal(got, mergepath.merge_plain(a, b, nk))


@pytest.mark.parametrize("k", [31, 63, 95])
def test_build_on_card_matches_cpu(cuda, k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    batches = []
    for i in range(24):
        st = rng.integers(0, len(genome) - 150, 256)
        b = np.stack([genome[s:s + 150] for s in st])
        b[rng.random(b.shape) < 0.005] = 4
        batches.append((b, i % 3))
    want = tstore.to_host(tb.build(batches, k, ncols=3, device="cpu"))
    got = tstore.to_host(tb.build(batches, k, ncols=3, device=cuda))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keys = torch.from_numpy(got[0].view(np.int64))
    assert torch.equal(sops.sort_by_key(keys)[0], keys)


def _lookup_case(W, n, Q, seed, b_bits=None, absent=False, sentinel=False,
                 row_words=32):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, size=(n, W), dtype=np.uint64),
                     axis=0)
    build = lookup.build_table32 if row_words == 32 else lookup.build_table128
    table, bb = build(keys, b_bits=b_bits)
    assert table.shape == (1 << bb, row_words)
    if absent:       # random words: present with negligible probability
        q = rng.integers(0, 1 << 62, size=(Q, W), dtype=np.uint64)
    else:
        q = keys[rng.integers(0, len(keys), Q)]
        q[rng.random(Q) < 0.3] = rng.integers(0, 1 << 62, size=W,
                                               dtype=np.uint64)
        q[rng.random(Q) < 0.05] = np.uint64(2**64 - 1)
    if sentinel:
        q[:] = np.uint64(2**64 - 1)
    return (torch.from_numpy(table.view(np.int32)), bb,
            torch.from_numpy(q.view(np.int64)))


def _check_lookup_kernel(table, bb, q, W, cuda):
    table, q = table.to(cuda), q.to(cuda)
    Q = q.shape[0]
    n0 = _build.LAUNCHES["lookup"]
    idx, found = lookup.lookup_fused(table, q, bb, W)
    assert _build.LAUNCHES["lookup"] == n0 + (1 if Q else 0)
    want = lookup.lookup_plain(table, q, bb, W)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    assert torch.equal(idx, want[0]) and torch.equal(found, want[1])
    return found, lookup.rows_read(table, q, bb, W)


# b_bits 1 and 2 are far too small: the 128-byte-row table grows only until
# the keys fit, so nearly every row is full and chains run over many rows
# and past the last row; the 128-lane table grows until no bucket overflows
@pytest.mark.parametrize("row_words", [32, 128])
@pytest.mark.parametrize("W,n,Q,b_bits,absent,sentinel", [
    (1, 5000, 4097, None, False, False), (2, 5000, 1000, None, False, False),
    (1, 300, 0, None, False, False), (2, 300, 1, None, False, False),
    (1, 300, 1, None, False, False), (1, 3000, 3, None, False, False),
    (2, 3000, 31, None, False, False), (3, 3000, 33, None, False, False),
    (4, 3000, 255, None, False, False), (4, 3000, 1030, None, False, False),
    (1, 2000, 333, None, True, False), (2, 2000, 77, None, False, True),
    (1, 20000, 5000, 1, False, False), (2, 20000, 5000, 2, False, False),
    (3, 9000, 2001, 1, False, False), (4, 9000, 2002, 1, True, False),
    (3, 4000, 999, None, False, False), (1, 200000, 300001, None, False,
                                         False)])
def test_lookup_kernel_matches_plain(cuda, W, n, Q, b_bits, absent,
                                     sentinel, row_words):
    table, bb, q = _lookup_case(W, n, Q, n + Q + W, b_bits, absent,
                                sentinel, row_words)
    found, rows = _check_lookup_kernel(table, bb, q, W, cuda)
    if sentinel or absent:
        assert not bool(found.any())
    elif Q > 100:
        assert bool(found.any())
    if b_bits is not None and row_words == 32 and not sentinel:
        assert int(rows.max()) >= 3              # forced chains


@pytest.mark.parametrize("W", [1, 2, 4])
def test_lookup_kernel_on_a_table_without_an_empty_slot(cuda, W):
    rng = np.random.default_rng(W)
    S = lookup.slots_for(W, 32)
    keys = np.unique(rng.integers(0, 1 << 62, size=(4 * S, W),
                                  dtype=np.uint64), axis=0)
    table, bb = lookup.build_table32(keys, b_bits=2)
    assert bb == 2 and (table[:, :S] != 0xFFFFFFFF).all()
    q = np.concatenate([keys, rng.integers(0, 1 << 62, size=(100, W),
                                           dtype=np.uint64),
                        np.full((3, W), np.uint64(2**64 - 1))])
    found, rows = _check_lookup_kernel(
        torch.from_numpy(table.view(np.int32)), bb,
        torch.from_numpy(q.view(np.int64)), W, cuda)
    assert int(found.sum()) == len(keys) and int(rows.max()) == 4


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_lookup_kernel_walks_on_from_full_128_lane_rows(cuda, W):
    """The reference-shaped table with full rows, the last among them: a
    probe for an absent key walks on and wraps."""
    rng = np.random.default_rng(10 + W)
    pool = np.unique(rng.integers(0, 1 << 62, size=(8000, W),
                                  dtype=np.uint64), axis=0)
    S, bb = lookup.slots_for(W), 4
    home = (hashidx._hash_np(pool) >> np.uint64(64 - bb)).astype(np.int64)
    order = np.argsort(home, kind="stable")
    rank = np.empty(len(pool), np.int64)
    rank[order] = np.arange(len(pool)) - np.searchsorted(home[order],
                                                         home[order])
    keys = pool[(rank < S) & ((home % 3 == 0) | (rank < S // 2))]
    table, got_b = lookup.build_table128(keys, b_bits=bb)
    full = (table[:, :S] != 0xFFFFFFFF).all(axis=1)
    assert got_b == bb and full[0] and full[15] and not full[1]
    q = np.concatenate([keys, pool[::2],
                        np.full((5, W), np.uint64(2**64 - 1))])
    found, rows = _check_lookup_kernel(
        torch.from_numpy(table.view(np.int32)), bb,
        torch.from_numpy(q.view(np.int64)), W, cuda)
    # from the last row over row 0, full too, into row 1
    assert bool(found[:len(keys)].all()) and int(rows.max()) == 3


def test_lookup_auto_takes_the_kernel_on_a_cuda_store(cuda, monkeypatch):
    monkeypatch.setattr(hashidx, "LOOKUP_IMPL", "auto")
    _t, _b, q = _lookup_case(1, 3000, 100, 5)
    keys = sops.sort_by_key(q.unique(dim=0))[0].to(cuda)
    n0 = _build.LAUNCHES["lookup"]
    idx, found = hashidx.lookup(keys, keys)
    assert _build.LAUNCHES["lookup"] == n0 + 1
    live = ~sops.is_sentinel(keys)
    assert torch.equal(found, live)
    assert torch.equal(idx[live], torch.arange(int(live.sum()), device=cuda,
                                               dtype=torch.int32))


@pytest.mark.parametrize("k", [11, 31, 33])
def test_clean_and_unitigs_on_card_match_cpu(cuda, k):
    from mccortex_tpu_torch.graph import clean as tclean
    from mccortex_tpu_torch.graph import unitigs as tu
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    batches = []
    for i in range(8):
        st = rng.integers(0, len(genome) - 100, 128)
        b = np.stack([genome[s:s + 100] for s in st])
        b[rng.random(b.shape) < 0.01] = rng.integers(0, 4)
        batches.append((b, i % 2))
    out = {}
    for dev in ("cpu", cuda):
        g = tb.build(batches, k, ncols=2, device=dev)
        g2 = tclean.clean_graph(g, covg_threshold=2, min_keep_tip=2 * k)
        out[str(dev)] = (tstore.to_host(g2), tu.extract_unitigs(g2))
    for g, w in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(g, w)
    assert out["cuda"][1] == out["cpu"][1] and len(out["cpu"][1]) > 0


@pytest.mark.parametrize("W,C", [(1, 1), (1, 3), (2, 2)])
def test_from_records_on_card_matches_cpu(cuda, W, C):
    rng = np.random.default_rng(W * 10 + C)
    pool = np.unique(rng.integers(0, 1 << 62, size=(3000, W),
                                  dtype=np.uint64), axis=0)
    keys = pool[rng.integers(0, len(pool), 20000)]
    keys[rng.random(20000) < 0.05] = np.uint64(2**64 - 1)
    keys = torch.from_numpy(keys.view(np.int64))
    covg = torch.from_numpy(rng.integers(-2**31, 2**31, size=(20000, C))
                            .astype(np.int32))
    edges = torch.from_numpy(rng.integers(0, 256, size=(20000, C))
                             .astype(np.uint8))
    k = 31 if W == 1 else 33
    n0 = _build.LAUNCHES["segreduce"]
    got = tstore.from_records(k, keys.to(cuda), covg.to(cuda), edges.to(cuda))
    assert _build.LAUNCHES["segreduce"] == n0 + 1
    want = tstore.from_records(k, keys, covg, edges)
    assert got.n == want.n and got.capacity == want.capacity == 20000
    for g, w in zip((got.keys, got.covg, got.edges),
                    (want.keys, want.covg, want.edges)):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# the sort kernels: tile sort, tail, butterfly, merge level
# ---------------------------------------------------------------------------

T = bitonic.TILE
ODD_SIZES = [1, T - 1, T, T + 1, 3 * T + 17]


def _records(seed, M, np_, nk, hi=2**32, sent_frac=0.1):
    """(np, M) int32 planes: nk random key planes (values below hi, so a
    small hi makes heavy ties), a share of all-ones keys, random payload."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, size=(nk, M), dtype=np.uint64).astype(np.uint32)
    keys[:, rng.random(M) < sent_frac] = 0xFFFFFFFF
    vals = rng.integers(0, 2**32, size=(np_ - nk, M), dtype=np.uint64
                        ).astype(np.uint32)
    return torch.from_numpy(np.concatenate([keys, vals]).view(np.int32))


def _stable(planes, nk):
    return planes[:, sops.argsort_planes(planes[:nk])]


def _same_up_to_ties(got, want, nk):
    """Key planes equal element for element; whole records the same
    multiset within every run of equal keys."""
    assert torch.equal(got[:nk], want[:nk])
    assert torch.equal(got[:, sops.argsort_planes(got)],
                       want[:, sops.argsort_planes(want)])


@pytest.mark.parametrize("M", ODD_SIZES)
@pytest.mark.parametrize("nk,np_,hi", [(1, 1, 5), (2, 3, 2**32), (2, 4, 3),
                                       (3, 3, 2**32), (4, 5, 2), (5, 9, 4),
                                       (6, 6, 2), (7, 12, 2), (8, 10, 2**32),
                                       (9, 11, 2)])
def test_block_sort_all_ascending_matches_plain(cuda, M, nk, np_, hi):
    x = _records(M + nk, M, np_, nk, hi).to(cuda)
    n0 = _build.LAUNCHES["bitonic_blocksort"]
    got = bitonic.block_sort(x, nk, all_asc=True)
    assert _build.LAUNCHES["bitonic_blocksort"] == n0 + 1
    assert torch.equal(got, bitonic.block_sort_plain(x, nk, True, T))


@pytest.mark.parametrize("all_asc", [True, False])
@pytest.mark.parametrize("sent_frac", [0.0, 1.0])
@pytest.mark.parametrize("nk,np_", [(1, 2), (2, 3), (3, 4), (4, 5), (9, 10)])
def test_block_sort_of_equal_keys_keeps_the_source_order(cuda, nk, np_,
                                                         sent_frac, all_asc):
    """All keys equal (one value, or all sentinels): an ascending tile
    keeps its records in place, a descending tile reverses them."""
    M = 4 * T if not all_asc else 3 * T + 5
    x = _records(nk, M, np_, nk, 1, sent_frac).to(cuda)
    got = bitonic.block_sort(x, nk, all_asc=all_asc)
    assert torch.equal(got, bitonic.block_sort_plain(x, nk, all_asc, T))
    want = x.clone()
    if not all_asc:
        rows = want.view(np_, -1, T)
        rows[:, 1::2] = rows[:, 1::2].flip(2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ntiles,nk,np_,hi", [(1, 2, 3, 2**32), (2, 2, 3, 4),
                                              (4, 3, 6, 2**32), (6, 3, 3, 2),
                                              (2, 4, 4, 2**32),
                                              (5, 1, 2, 7), (8, 4, 5, 2),
                                              (3, 9, 12, 2)])
def test_block_sort_alternating_matches_plain(cuda, ntiles, nk, np_, hi):
    x = _records(ntiles, ntiles * T, np_, nk, hi).to(cuda)
    got = bitonic.block_sort(x, nk, all_asc=False)
    assert torch.equal(got, bitonic.block_sort_plain(x, nk, False, T))


@pytest.mark.parametrize("span", [T, 2 * T])
@pytest.mark.parametrize("ntiles,k,final_asc,nk,np_,hi", [
    (4, 2 * T, False, 2, 3, 2**32), (4, 4 * T, True, 2, 4, 5),
    (8, 4 * T, False, 1, 2, 3), (2, 2 * T, True, 4, 5, 2),
    (8, 2 * T, False, 4, 5, 2**32), (8, 2 * T, False, 3, 4, 3),
    (4, 2 * T, False, 1, 1, 2**32), (4, 2 * T, True, 2, 14, 2),
    (16, 8 * T, False, 8, 9, 2), (4, 2 * T, False, 5, 6, 2),
    (4, 2 * T, True, 9, 10, 3)])
def test_tail_and_butterfly_match_plain(cuda, ntiles, k, final_asc, nk, np_,
                                        hi, span):
    """The tail in registers (up to 4 key planes) and in shared memory
    (above), over spans of one tile and of two, ascending and descending
    spans, against the plain network."""
    x = _records(k + ntiles, ntiles * T, np_, nk, hi).to(cuda)
    if nk > 4 and span > T:         # the tail in shared memory spans a tile
        with pytest.raises(ValueError):
            bitonic.tail(x, nk, k, final_asc, tile=span)
        return
    n0 = _build.LAUNCHES["bitonic_tail"]
    got = bitonic.tail(x, nk, k, final_asc, tile=span)
    assert _build.LAUNCHES["bitonic_tail"] == n0 + 1
    assert torch.equal(got, bitonic.tail_plain(x, nk, k, final_asc, span))
    j = k // 2
    while j >= T:
        want = bitonic.cmpx_plain(x, nk, j, k, final_asc)
        n0 = _build.LAUNCHES["bitonic_butterfly"]
        got = bitonic.butterfly(x.clone(), nk, j, k, final_asc)
        assert _build.LAUNCHES["bitonic_butterfly"] == n0 + 1
        assert torch.equal(got, want)
        j //= 2


@pytest.mark.parametrize("span", [T, 2 * T])
@pytest.mark.parametrize("final_asc", [False, True])
@pytest.mark.parametrize("sent_frac", [0.0, 1.0])
@pytest.mark.parametrize("nk,np_", [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6),
                                    (9, 10)])
def test_tail_of_equal_keys_moves_nothing(cuda, nk, np_, sent_frac,
                                          final_asc, span):
    """All keys equal (one value, or all sentinels) and distinct payloads:
    no compare-exchange swaps, in either direction, so every record stays
    where it is and none is dropped or doubled."""
    M = 8 * T
    x = _records(nk, M, np_, nk, 1, sent_frac)
    x[nk] = torch.arange(M, dtype=torch.int32)
    x = x.to(cuda)
    span = span if nk <= 4 else T
    got = bitonic.tail(x, nk, 2 * T, final_asc, tile=span)
    assert torch.equal(got, x)


@pytest.mark.parametrize("span", [T, 2 * T])
def test_sort_planes_is_the_same_at_either_tail_span(cuda, monkeypatch, span):
    monkeypatch.setattr(bitonic, "TAIL_WIDE_KEYS", 4 if span > T else 0)
    assert bitonic.tail_span(2) == span
    x = bitonic.pad_planes(_records(span, 100_000, 4, 2, 50), 2,
                           bitonic.padded_length(100_000)).to(cuda)
    _build.LAUNCHES.clear()
    got = bitonic.sort_planes(x, 2)
    stages = (x.shape[1] // T).bit_length() - 1
    assert _build.LAUNCHES["bitonic_tail"] == stages
    assert _build.LAUNCHES["bitonic_butterfly"] == \
        sum(range(1, stages + 1)) - (stages if span > T else 0)
    assert torch.equal(got.cpu(), bitonic.sort_planes_plain(x.cpu(), 2))


@pytest.mark.parametrize("M,nk,np_,hi", [(1, 1, 1, 3), (T - 1, 2, 3, 2**32),
                                         (T + 1, 2, 3, 4),
                                         (3 * T + 17, 4, 5, 2),
                                         (8 * T, 2, 4, 2**32),
                                         (100_000, 9, 12, 2)])
def test_sort_and_merge_planes_match_plain(cuda, M, nk, np_, hi):
    x = _records(M, M, np_, nk, hi, sent_frac=0.0)
    Mp = bitonic.padded_length(M)
    xp = bitonic.pad_planes(x, nk, Mp)
    got = bitonic.sort_planes(xp.to(cuda), nk).cpu()
    want = bitonic.sort_planes(xp, nk)                  # plain, same network
    assert torch.equal(got, want)
    _same_up_to_ties(got[:, :M], _stable(x, nk), nk)
    a = bitonic.pad_planes(_stable(x[:, :M // 2], nk), nk, Mp)
    b = bitonic.pad_planes(_stable(x[:, M // 2:], nk), nk, Mp)
    got = bitonic.merge_planes(a.to(cuda), b.to(cuda), nk).cpu()
    assert torch.equal(got, bitonic.merge_planes(a, b, nk))
    _same_up_to_ties(got[:, :M], _stable(x, nk), nk)


@pytest.mark.parametrize("fuse", [0, mergepath.FUSE_RECORDS])
@pytest.mark.parametrize("M,R,nk,np_,hi", [
    (1, 1, 1, 1, 2), (T - 1, 100, 2, 3, 2**32), (T + 1, T, 2, 3, 3),
    (3 * T + 17, T, 2, 4, 5), (3 * T + 17, 2 * T, 4, 5, 2),
    (50_000, 777, 1, 2, 9), (50_000, 5000, 8, 8, 2), (9000, 1 << 20, 9, 12, 2),
    (70_001, 8 * T, 3, 6, 2**32), (40_000, T, 2, 3, 1), (30_000, T, 5, 20, 2),
    (245_760, T, 2, 3, 2**32), (5000, 1, 2, 3, 4)])
def test_merge_level_kernel_matches_plain(cuda, monkeypatch, M, R, nk, np_, hi,
                                          fuse):
    """One level, by the kernel that merges a pair's tiles (fuse = 0) and,
    where a pair fits in a block's shared memory, by the one that stages
    whole groups: one launch either way."""
    monkeypatch.setattr(mergepath, "FUSE_RECORDS", fuse)
    x = _records(M + R, M, np_, nk, hi)
    for s in range(0, M, R):                      # runs of R, each sorted
        x[:, s:s + R] = _stable(x[:, s:s + R], nk)
    n0 = _build.LAUNCHES["mergelevel"]
    got = mergepath.merge_level(x.to(cuda), nk, R)
    assert _build.LAUNCHES["mergelevel"] == n0 + 1
    assert torch.equal(got.cpu(), mergepath.merge_level_plain(x, nk, R))
    for s in range(0, M, 2 * R):                  # stable merge of each pair
        assert torch.equal(got[:, s:s + 2 * R].cpu(),
                           _stable(x[:, s:s + 2 * R], nk))


def _launches_of_levels(np_, M, R, levels):
    """Kernel launches merge_levels makes: fused groups of levels while
    they fit, then one a level, until one run is left."""
    n, R = 0, min(R, M)
    while True:
        step = max(mergepath.fused_levels(np_, R, levels), 1)
        n, levels, R = n + 1, levels - step, R << step
        if levels == 0 or R >= M:
            return n


@pytest.mark.parametrize("M,R,levels,nk,np_,hi", [
    (T - 1, 100, 3, 2, 3, 2**32), (3 * T + 17, T, 2, 2, 4, 5),
    (245_760, T, 3, 2, 3, 2**32), (245_760, T, 7, 2, 3, 7),
    (180_224, T, 7, 4, 5, 2**32), (180_224, T, 2, 4, 5, 2),
    (50_000, 777, 6, 1, 2, 9), (50_000, 1, 16, 1, 1, 2**32),
    (33_000, 500, 4, 5, 6, 2), (33_000, 64, 9, 9, 10, 2),
    (70_001, T, 4, 3, 6, 2**32), (16 * T + 5, T, 3, 2, 3, 1),
    (9 * T, T, 3, 2, 3, 3), (40_000, 3 * T // 2, 3, 2, 3, 2**32),
    (100_000, 4 * T, 5, 2, 3, 11)])
def test_merge_levels_kernel_matches_plain(cuda, M, R, levels, nk, np_, hi):
    """Several levels a call (the first ones fused while their groups fit
    in shared memory) against the plain levels and a stable sort of every
    group: M below a tile, ragged last runs and groups, a last run
    without partner, R = 1, R no multiple of the tile, heavy ties with
    distinct payloads."""
    x = _records(M + R + levels, M, np_, nk, hi)
    for s in range(0, M, R):
        x[:, s:s + R] = _stable(x[:, s:s + R], nk)
    n0 = _build.LAUNCHES["mergelevel"]
    got = mergepath.merge_levels(x.to(cuda), nk, R, levels).cpu()
    assert _build.LAUNCHES["mergelevel"] - n0 == \
        _launches_of_levels(np_, M, R, levels)
    assert torch.equal(got, mergepath.merge_levels_plain(x, nk, R, levels))
    G = R << levels
    for s in range(0, M, G):
        assert torch.equal(got[:, s:s + G], _stable(x[:, s:s + G], nk))


def test_an_epoch_sort_makes_fewer_trips_than_its_levels(cuda):
    """An epoch's sort_planes_mp: the tile sort, one launch for the first
    levels (those whose groups fit, fused_levels) and one for each of
    the others."""
    x = _records(5, 245_760, 3, 2, 2**32).to(cuda)
    _build.LAUNCHES.clear()
    got = mergepath.sort_planes_mp(x, 2)
    assert _build.LAUNCHES["bitonic_blocksort"] == 1
    assert _build.LAUNCHES["mergelevel"] == _launches_of_levels(
        3, 245_760, T, 7) < 7
    assert torch.equal(got, _stable(x, 2))


@pytest.mark.parametrize("M", ODD_SIZES + [250_000])
@pytest.mark.parametrize("nk,np_,hi", [(1, 2, 4), (2, 3, 2**32), (4, 5, 3),
                                       (8, 12, 2), (9, 10, 2)])
def test_sort_planes_mp_kernel_is_a_stable_sort(cuda, M, nk, np_, hi):
    x = _records(M * nk, M, np_, nk, hi)
    got = mergepath.sort_planes_mp(x.to(cuda), nk).cpu()
    assert torch.equal(got, _stable(x, nk))
    again = mergepath.sort_planes_mp(x.to(cuda), nk).cpu()
    assert torch.equal(got, again)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_lookup_join_mp_on_card_matches_lax(cuda, W):
    rng = np.random.default_rng(W)
    keys = np.unique(rng.integers(0, 1 << 62, size=(30_000, W),
                                  dtype=np.uint64), axis=0)
    q = keys[rng.integers(0, len(keys), 50_001)]
    q[rng.random(len(q)) < 0.3] = rng.integers(0, 1 << 62, size=W,
                                               dtype=np.uint64)
    q[rng.random(len(q)) < 0.05] = np.uint64(2**64 - 1)
    keys = torch.from_numpy(keys.view(np.int64)).to(cuda)
    keys = sops.sort_by_key(keys)[0]
    q = torch.from_numpy(q.view(np.int64)).to(cuda)
    _build.LAUNCHES.clear()
    idx, found = sops.lookup_join(keys, q, variant="mp")
    assert _build.LAUNCHES["mergepath"] == 1
    assert _build.LAUNCHES["bitonic_blocksort"] == 2
    assert _build.LAUNCHES["mergelevel"] > 0
    want = sops.lookup_join(keys, q)
    assert torch.equal(idx, want[0]) and torch.equal(found, want[1])
    assert bool(found.any()) and not bool(found.all())


@pytest.mark.parametrize("engine", ["lax", "mp", "bitonic"])
@pytest.mark.parametrize("k", [31, 63])
def test_build_per_engine_on_card_matches_cpu(cuda, monkeypatch, engine, k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    batches = []
    for i in range(12):
        st = rng.integers(0, len(genome) - 150, 256)
        b = np.stack([genome[s:s + 150] for s in st])
        b[rng.random(b.shape) < 0.005] = 4
        batches.append((b, i % 2))
    monkeypatch.setattr(tb, "SORT_IMPL", "lax")
    want = tstore.to_host(tb.build(batches, k, ncols=2, device="cpu"))
    monkeypatch.setattr(tb, "SORT_IMPL", engine)
    _build.LAUNCHES.clear()
    got = tstore.to_host(tb.build(batches, k, ncols=2, device=cuda))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if engine == "mp":
        assert _build.LAUNCHES["bitonic_blocksort"] == 12
        assert _build.LAUNCHES["mergelevel"] > 0
    if engine == "bitonic":
        assert _build.LAUNCHES["bitonic_tail"] > 0
        assert _build.LAUNCHES["bitonic_butterfly"] > 0
        assert _build.LAUNCHES["mergepath"] == 0


# ---------------------------------------------------------------------------
# the graph-phase and link-file commands: the card writes the CPU's bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_colour_ctx(tmp_path_factory):
    """A two-colour k=31 graph (the second colour with SNPs), built on the
    CPU, a FASTA of a slice of its genome, and a two-colour link file of
    random links written by the port."""
    from mccortex_tpu_torch.cli.main import main
    from mccortex_tpu_torch.io import ctp
    from mccortex_tpu_torch.links import store as ls
    d = tmp_path_factory.mktemp("graph_cmds_gpu")
    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    alt = genome.copy()
    snp = rng.random(len(alt)) < 0.004
    alt[snp] = (alt[snp] + 1) % 4
    args = []
    for name, g in (("a", genome), ("b", alt)):
        fa = str(d / f"{name}.fa")
        with open(fa, "w") as fh:
            for i, s in enumerate(rng.integers(0, len(g) - 150, 1500)):
                fh.write(f">r{i}\n" + "".join("ACGT"[c] for c in g[s:s + 150])
                         + "\n")
        args += ["--sample", name, "--seq", fa]
    p = {"d": d, "ctx": str(d / "g.ctx"), "seq": str(d / "slice.fa")}
    assert main(["build", "-k", "31"] + args + [p["ctx"], "--device", "cpu",
                                                "-q"]) == 0
    with open(p["seq"], "w") as fh:
        fh.write(">s\n" + "".join("ACGT"[c] for c in genome[5000:7000]) + "\n")
    g = _load(p["ctx"], "cpu")
    L = 300
    rows = rng.integers(0, g.n, L)
    bases = rng.integers(0, 4, (L, 40)).astype(np.uint8)
    links = ls.build_store(g.keys, rows, rng.integers(0, 2, L), bases,
                           rng.integers(1, 41, L), rng.integers(0, 2, L), 2)
    p["ctp"] = str(d / "l.ctp.gz")
    ctp.save_ctp(p["ctp"], g, links, sample_names=["a", "b"])
    return p


def _load(path, device):
    from mccortex_tpu_torch.cli.commands import _load_graph
    return _load_graph(path, device)[1]


def _text_of(path):
    import gzip
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


@pytest.mark.parametrize("cmd", [
    ["contigs", "-o", "OUT"], ["contigs", "-c", "1", "-N", "50", "-o", "OUT"],
    ["inferedges", "-o", "OUT"], ["inferedges", "--all", "-o", "OUT"],
    ["subgraph", "--seq", "SEQ", "--dist", "5", "-o", "OUT"],
    ["subgraph", "--seq", "SEQ", "-U", "--invert", "-o", "OUT"],
    ["pjoin", "-r", "-c", "2", "-o", "OUT", "CTX", "CTP"],
    ["pview", "CTX", "CTP"]])
def test_graph_command_on_card_matches_cpu(cuda, two_colour_ctx, monkeypatch,
                                           capsys, cmd):
    """Each new command writes the same bytes (decompressed for .ctp, the
    date fixed) from the card as from the plain versions on the CPU; the
    commands that read the store's adjacency launch the lookup kernel."""
    import time
    from mccortex_tpu_torch.cli.main import main
    p = two_colour_ctx
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "fixed")
    got = {}
    for dev in ("cuda", "cpu"):
        out = str(p["d"] / f"{cmd[0]}_{len(cmd)}_{dev}.out")
        argv = [{"OUT": out, "SEQ": p["seq"], "CTX": p["ctx"],
                 "CTP": p["ctp"]}.get(a, a) for a in cmd]
        if cmd[0] not in ("pjoin", "pview"):
            argv.append(p["ctx"])
        if cmd[0] != "pview":
            argv += ["--device", dev, "-f"]
        _build.LAUNCHES.clear()
        capsys.readouterr()
        assert main(argv) == 0
        text = capsys.readouterr().out
        got[dev] = (_text_of(out) if "OUT" in cmd else text.encode(),
                    dict(_build.LAUNCHES))
    assert got["cuda"][0] == got["cpu"][0] and len(got["cpu"][0]) > 0
    if cmd[0] in ("contigs", "inferedges", "subgraph"):
        assert got["cuda"][1].get("lookup", 0) > 0
        assert not got["cpu"][1].get("lookup", 0)


@pytest.fixture(scope="module")
def link_inputs(tmp_path_factory):
    """A k=31 graph of a 30 kb genome with 20 planted 300 bp repeats,
    built from its error-free reads, and reads of it with 0.5 %
    substitutions to thread (each substitution a gap to fill)."""
    from mccortex_tpu_torch.cli.main import main
    d = tmp_path_factory.mktemp("links_gpu")
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 30_000)
    unit = rng.integers(0, 4, 300)
    for s in rng.integers(0, 30_000 - 300, 20):
        genome[s:s + 300] = unit
    starts = rng.integers(0, len(genome) - 150, 3000)
    reads = np.stack([genome[s:s + 150] for s in starts])
    fa, fq = str(d / "clean.fa"), str(d / "reads.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">c{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    err = rng.random(reads.shape) < 0.005
    reads = np.where(err, (reads + 1) % 4, reads)
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    p = {"d": d, "ctx": str(d / "g.ctx"), "seq": fq, "genome": genome}
    assert main(["build", "-k", "31", "-s", "s", "--seq", fa, p["ctx"],
                 "--device", "cpu", "-q"]) == 0
    p["ctp"] = str(d / "l.ctp.gz")
    assert main(["thread", "--seq", fq, "-o", p["ctp"], p["ctx"],
                 "--device", "cpu", "-q"]) == 0
    return p


@pytest.mark.parametrize("cmd", [
    ["thread", "--seq", "SEQ", "-o", "OUT"],
    ["thread", "--no-gap-fill", "--seq", "SEQ", "-o", "OUT"],
    ["thread", "-W", "-p", "CTP", "-0", "--seq", "SEQ", "-o", "OUT"],
    ["contigs", "-p", "CTP", "-o", "OUT"],
    ["contigs", "-p", "CTP", "-P", "-C", "0.5", "-G", "30000", "--max-len",
     "2000", "-o", "OUT"],
    ["check", "-p", "CTP"]])
def test_link_command_on_card_matches_cpu(cuda, link_inputs, monkeypatch,
                                          capsys, cmd):
    """thread (gap-filled and plain), contigs -p and check -p write the
    same bytes (decompressed for .ctp, the date fixed) and status from the
    card as from the plain versions on the CPU, and launch the lookup
    kernel on the card."""
    import re
    import time
    from mccortex_tpu_torch.cli.main import main
    p = link_inputs
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "fixed")
    out = str(p["d"] / "out")
    argv = [{"OUT": out, "SEQ": p["seq"], "CTP": p["ctp"]}.get(a, a)
            for a in cmd] + [p["ctx"]]
    got = {}
    for dev in ("cuda", "cpu"):
        _build.LAUNCHES.clear()
        capsys.readouterr()
        assert main(argv + ["--device", dev, "-f"]) == 0
        err = re.sub(r"time split: .*", "", capsys.readouterr().err)
        got[dev] = (_text_of(out) if "OUT" in cmd else b"", err,
                    dict(_build.LAUNCHES))
    assert got["cuda"][:2] == got["cpu"][:2]
    assert got["cuda"][2].get("lookup", 0) > 0
    assert not got["cpu"][2].get("lookup", 0)


@pytest.fixture(scope="module")
def pair_inputs(link_inputs):
    """256 FR pairs of 100 bp from fragments of 300-400 bp of the
    link_inputs genome with 0.5 % substitutions, as two FASTA files and
    one interleaved file, and the first 100 reads of link_inputs."""
    p = dict(link_inputs)
    d, genome = p["d"], p["genome"]
    rng = np.random.default_rng(14)
    flen = rng.integers(300, 401, 256)
    starts = rng.integers(0, len(genome) - 400, 256)
    m1 = np.stack([genome[s:s + 100] for s in starts])
    m2 = np.stack([3 - genome[s + f - 100:s + f][::-1]
                   for s, f in zip(starts, flen)])
    m1 = np.where(rng.random(m1.shape) < 0.005, (m1 + 1) % 4, m1)
    m2 = np.where(rng.random(m2.shape) < 0.005, (m2 + 1) % 4, m2)
    names = {n: str(d / n) for n in ("r1.fa", "r2.fa", "il.fa", "q100.fa")}
    with open(names["r1.fa"], "w") as f1, open(names["r2.fa"], "w") as f2, \
            open(names["il.fa"], "w") as fi:
        for i, (a, b) in enumerate(zip(m1, m2)):
            sa = "".join("ACGT"[c] for c in a)
            sb = "".join("ACGT"[c] for c in b)
            f1.write(f">p{i}/1\n{sa}\n")
            f2.write(f">p{i}/2\n{sb}\n")
            fi.write(f">p{i}/1\n{sa}\n>p{i}/2\n{sb}\n")
    with open(p["seq"]) as src, open(names["q100.fa"], "w") as dst:
        dst.write("".join(src.readlines()[:200]))
    p.update({k.split(".")[0].upper(): v for k, v in names.items()})
    return p


@pytest.mark.parametrize("cmd", [
    ["thread", "-2", "R1", "R2", "-o", "OUT", "CTX"],
    ["thread", "-i", "IL", "-W", "--seq", "Q100", "-o", "OUT", "CTX"],
    ["links", "-c", "2", "-l", "OUT2", "-T", "OUT3", "-o", "OUT", "CTX",
     "CTP"],
    ["links", "-H", "OUT2", "-P", "OUT3", "-L", "5", "CTX", "CTP"],
    ["reads", "--seq", "SEQ", "-o", "OUT", "CTX"],
    ["reads", "-F", "fasta", "-1", "SEQ:OUT", "-2", "R1:R2:OUT2", "-i",
     "IL:OUT3", "CTX"],
    ["coverage", "-1", "Q100", "-e", "-E", "-o", "OUT", "CTX", "CTX"],
    ["correct", "-1", "SEQ", "-o", "OUT", "CTX"],
    ["correct", "-2", "R1", "R2", "-o", "OUT", "-p", "CTP", "-W", "CTX"],
    ["correct", "-i", "IL:OUT", "-F", "fastq", "-L", "500", "CTX"]])
def test_reads_correct_commands_on_card_match_cpu(cuda, pair_inputs,
                                                 monkeypatch, capsys, cmd):
    """thread -2/-i, links, reads, coverage and correct write the same
    bytes (decompressed, the date fixed) and status from the card as
    from the plain versions on the CPU, and launch the lookup kernel on
    the card."""
    import glob
    import os
    import re
    import time
    from mccortex_tpu_torch.cli.main import main
    p = pair_inputs
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "fixed")
    outs = {f"OUT{i}".rstrip("1"): str(p["d"] / f"rc_out{i}")
            for i in (1, 2, 3)}
    sub = dict(outs, SEQ=p["seq"], CTX=p["ctx"], CTP=p["ctp"], R1=p["R1"],
               R2=p["R2"], IL=p["IL"], Q100=p["Q100"])
    argv = [":".join(sub.get(x, x) for x in a.split(":")) for a in cmd]
    got = {}
    for dev in ("cuda", "cpu"):
        for path in glob.glob(str(p["d"] / "rc_out*")):
            os.remove(path)
        _build.LAUNCHES.clear()
        capsys.readouterr()
        assert main(argv + ["--device", dev]) == 0
        err = re.sub(r"time split: .*", "", capsys.readouterr().err)
        files = {os.path.basename(f): _text_of(f)
                 for f in sorted(glob.glob(str(p["d"] / "rc_out*")))}
        got[dev] = (files, err, dict(_build.LAUNCHES))
    assert got["cuda"][:2] == got["cpu"][:2]
    assert got["cpu"][0] and all(len(v) for v in got["cpu"][0].values())
    assert got["cuda"][2].get("lookup", 0) > 0
    assert not got["cpu"][2].get("lookup", 0)


@pytest.fixture(scope="module")
def calling_inputs(tmp_path_factory):
    """A k=31 graph in two colours: a sample (reads of a 20 kb genome with
    12 SNPs, a 5 bp deletion and an 8 bp insertion planted) and its
    reference; the bubble calls, VCF and covered VCF the calling
    commands read.  Made on the CPU, only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mccortex_tpu_torch.cli.main import main
    d = tmp_path_factory.mktemp("calling_gpu")
    rng = np.random.default_rng(15)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 20_000))
    sample = list(genome)
    for p in range(1_000, 19_000, 1_500):
        sample[p] = "ACGT"[("ACGT".index(genome[p]) + 1) % 4]
    sample[5_600:5_605] = []
    sample[12_300:12_300] = list("GATTACAG")
    sample = "".join(sample)
    starts = rng.integers(0, len(sample) - 100, 3_000)
    p = {k: str(d / v) for k, v in (
        ("REF", "ref.fa"), ("READS", "reads.fa"), ("CTX", "g.ctx"),
        ("BUB", "bub.txt.gz"), ("VCF", "calls.vcf"), ("COVVCF", "cov.vcf"))}
    with open(p["REF"], "w") as fh:
        fh.write(f">chr1\n{genome}\n")
    with open(p["READS"], "w") as fh:
        for i, s in enumerate(starts):
            fh.write(f">r{i}\n{sample[s:s + 100]}\n")
    cpu = ["--device", "cpu", "-q"]
    for argv in (["build", "-k", "31", "-s", "s", "--seq", p["READS"],
                  str(d / "s.ctx")],
                 ["build", "-k", "31", "-s", "ref", "--seq", p["REF"],
                  str(d / "r.ctx")],
                 ["join", "-o", p["CTX"], str(d / "s.ctx"), str(d / "r.ctx")],
                 ["bubbles", "-o", p["BUB"], p["CTX"]],
                 ["calls2vcf", "-o", p["VCF"], p["BUB"], p["REF"]],
                 ["vcfcov", "-r", p["REF"], "-o", p["COVVCF"], p["VCF"],
                  p["CTX"]]):
        assert main(argv + cpu) == 0
    p["d"] = d
    return p


@pytest.mark.parametrize("cmd,lookup", [
    (["bubbles", "-H", "1", "-o", "OUT", "CTX"], True),
    (["popbubbles", "-o", "OUT", "CTX"], True),
    (["calls2vcf", "-O", "bcf", "-o", "OUT", "BUB", "REF"], False),
    (["breakpoints", "-s", "REF", "-o", "OUT", "CTX"], True),
    (["vcfcov", "-r", "REF", "-o", "OUT", "VCF", "CTX"], True),
    (["vcfgeno", "-k", "31", "--kcov", "20", "-l", "-o", "OUT", "COVVCF"],
     False),
    (["pipeline", "-k", "31", "--sample", "s:READS", "--ref", "REF",
      "--kcov", "20", "-o", "OUT"], True)])
def test_calling_command_on_card_matches_cpu(cuda, calling_inputs,
                                             monkeypatch, capsys, cmd,
                                             lookup):
    """bubbles, popbubbles, calls2vcf, breakpoints, vcfcov, vcfgeno and
    pipeline write the same bytes (decompressed, the date fixed) and
    status from the card as from the plain versions on the CPU.  Those
    that read a graph launch the lookup kernel on the card; calls2vcf
    and vcfgeno read only a call file or a VCF and launch nothing."""
    import os
    import re
    import shutil
    import time
    from mccortex_tpu_torch.cli.main import main
    p = calling_inputs
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "fixed")
    out = str(p["d"] / "call_out")
    argv = [out if x == "OUT" else ":".join(p.get(y, y) for y in
                                            x.split(":")) for x in cmd]
    got = {}
    for dev in ("cuda", "cpu"):
        if os.path.isdir(out):
            shutil.rmtree(out)
        elif os.path.exists(out):
            os.remove(out)
        _build.LAUNCHES.clear()
        capsys.readouterr()
        assert main(argv + ["--device", dev]) == 0
        # the pipeline's build steps name the device and time themselves
        err = re.sub(r"time split: .*|[\d.]+s\b|on .* \(sort engine", "",
                     capsys.readouterr().err)
        paths = ([os.path.join(out, f) for f in sorted(os.listdir(out))]
                 if os.path.isdir(out) else [out])
        files = {os.path.basename(f): _text_of(f) for f in paths}
        got[dev] = (files, err, dict(_build.LAUNCHES))
    assert got["cuda"][:2] == got["cpu"][:2]
    assert all(len(v) for v in got["cpu"][0].values())
    assert (got["cuda"][2].get("lookup", 0) > 0) == lookup
    assert not got["cpu"][2]

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
                                   (31, 5, 20), (21, 3, 3000)])
def test_frontend_kernel_matches_plain(cuda, k, B, L):
    bases = _reads(k * B + L, B, L).to(cuda)
    n0 = _build.LAUNCHES["frontend"]
    got = frontend.records_fused(bases, k)
    assert _build.LAUNCHES["frontend"] == n0 + 1
    want = frontend.records_plain(bases, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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


def _lookup_case(W, n, Q, seed, b_bits=None, absent=False, sentinel=False):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, size=(n, W), dtype=np.uint64),
                     axis=0)
    table, bb = lookup.build_table128(keys, b_bits=b_bits)
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


@pytest.mark.parametrize("W,n,Q,b_bits,absent,sentinel", [
    (1, 5000, 4097, None, False, False), (2, 5000, 1000, None, False, False),
    (1, 300, 0, None, False, False), (2, 300, 1, None, False, False),
    (1, 2000, 333, None, True, False), (2, 2000, 77, None, False, True),
    (1, 20000, 5000, 1, False, False), (2, 20000, 5000, 2, False, False),
    (3, 4000, 999, None, False, False), (1, 200000, 300001, None, False,
                                         False)])
def test_lookup_kernel_matches_plain(cuda, W, n, Q, b_bits, absent,
                                     sentinel):
    table, bb, q = _lookup_case(W, n, Q, n + Q + W, b_bits, absent,
                                sentinel)
    table, q = table.to(cuda), q.to(cuda)
    n0 = _build.LAUNCHES["lookup"]
    idx, found = lookup.lookup_fused(table, q, bb, W)
    assert _build.LAUNCHES["lookup"] == n0 + (1 if Q else 0)
    want = lookup.lookup_plain(table, q, bb, W)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    assert torch.equal(idx, want[0]) and torch.equal(found, want[1])
    if sentinel or absent:
        assert not bool(found.any())
    elif Q > 100:
        assert bool(found.any())


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


@pytest.mark.parametrize("ntiles,nk,np_,hi", [(1, 2, 3, 2**32), (2, 2, 3, 4),
                                              (5, 1, 2, 7), (8, 4, 5, 2),
                                              (3, 9, 12, 2)])
def test_block_sort_alternating_matches_plain(cuda, ntiles, nk, np_, hi):
    x = _records(ntiles, ntiles * T, np_, nk, hi).to(cuda)
    got = bitonic.block_sort(x, nk, all_asc=False)
    assert torch.equal(got, bitonic.block_sort_plain(x, nk, False, T))


@pytest.mark.parametrize("ntiles,k,final_asc,nk,np_,hi", [
    (4, 2 * T, False, 2, 3, 2**32), (4, 4 * T, True, 2, 4, 5),
    (8, 4 * T, False, 1, 2, 3), (2, 2 * T, True, 4, 5, 2),
    (16, 8 * T, False, 8, 9, 2)])
def test_tail_and_butterfly_match_plain(cuda, ntiles, k, final_asc, nk, np_,
                                        hi):
    x = _records(k + ntiles, ntiles * T, np_, nk, hi).to(cuda)
    n0 = _build.LAUNCHES["bitonic_tail"]
    got = bitonic.tail(x, nk, k, final_asc)
    assert _build.LAUNCHES["bitonic_tail"] == n0 + 1
    assert torch.equal(got, bitonic.tail_plain(x, nk, k, final_asc, T))
    j = k // 2
    while j >= T:
        want = bitonic.cmpx_plain(x, nk, j, k, final_asc)
        n0 = _build.LAUNCHES["bitonic_butterfly"]
        got = bitonic.butterfly(x.clone(), nk, j, k, final_asc)
        assert _build.LAUNCHES["bitonic_butterfly"] == n0 + 1
        assert torch.equal(got, want)
        j //= 2


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


@pytest.mark.parametrize("M,R,nk,np_,hi", [
    (1, 1, 1, 1, 2), (T - 1, 100, 2, 3, 2**32), (T + 1, T, 2, 3, 3),
    (3 * T + 17, T, 2, 4, 5), (3 * T + 17, 2 * T, 4, 5, 2),
    (50_000, 777, 1, 2, 9), (50_000, 5000, 8, 8, 2), (9000, 1 << 20, 9, 12, 2),
    (70_001, 8 * T, 3, 6, 2**32)])
def test_merge_level_kernel_matches_plain(cuda, M, R, nk, np_, hi):
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

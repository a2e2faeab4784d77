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
from mccortex_tpu_torch.ops.kernels import _build, frontend, mergepath
from mccortex_tpu_torch.ops.kernels import segreduce

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

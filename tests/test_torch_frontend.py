"""The port's front-end (plain version, which CPU tensors take) against
the Pallas front-end mccortex_tpu.ops.pallas.frontend.records_fused in
interpret mode and against mccortex_tpu.graph.build.reads_to_records.
Integer outputs: exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import build as jb
from mccortex_tpu.ops.pallas import frontend as jfe
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.ops.kernels import frontend as tfe


def _bases(seed, B, L):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.03] = 4               # N bases
    bases[1, L // 2:] = 4                               # a short read
    return bases


_JAX_RECORDS = {}


def _jax_records(k, L):
    """A batch and the Pallas front-end's planes of it (interpret mode),
    computed once for the tests of this file."""
    if (k, L) not in _JAX_RECORDS:
        bases = _bases(900 + k + L, 24, L)
        want = jfe.records_fused(jnp.asarray(bases), k, interpret=True,
                                 with_valid=False)
        _JAX_RECORDS[k, L] = bases, [np.asarray(w) for w in want]
    return _JAX_RECORDS[k, L]


CASES = [(11, 100), (31, 100), (33, 150), (63, 150), (31, 20)]


@pytest.mark.parametrize("k,L", CASES)
def test_records_match_pallas_kernel(k, L):
    bases, want = _jax_records(k, L)
    got = tfe.records_fused(torch.from_numpy(bases), k)
    assert len(got) == len(want) == (3 if k <= 31 else 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == bases.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,L", CASES)
def test_records_epoch_matches_pallas_kernel_cut_to_the_epoch(k, L):
    """records_epoch: the Pallas front-end's planes, each row cut to its
    first L - k + 1 windows (one where L < k), as one tensor."""
    bases, want = _jax_records(k, L)
    lv = tfe.epoch_windows(L, k)
    assert lv == max(L - k + 1, 1)
    got = tfe.records_epoch(torch.from_numpy(bases), k)
    assert got.dtype == torch.int32 and got.shape == (len(want), 24 * lv)
    np.testing.assert_array_equal(
        got.numpy(), np.stack(want)[:, :, :lv].reshape(len(want), -1))


@pytest.mark.parametrize("L", [0, 20, 31, 32, 100])
def test_records_at_k32_are_one_key_word(L):
    """k = 32 takes one 64-bit word (two key planes), as the port's plain
    path and JAX's reads_to_records have it; the CUDA front-end once wrote
    four there.  (The reference's Pallas front-end gives four planes at
    k = 32, and its count_batch_fused reads the wrong two of them: not
    copied.)"""
    bases = _bases(32 + L, 12, L) if L else np.zeros((12, 0), np.uint8)
    lv = tfe.epoch_windows(L, 32)
    got = tfe.records_epoch(torch.from_numpy(bases), 32)
    assert got.shape == (3, 12 * lv)
    assert len(tfe.records_fused(torch.from_numpy(bases), 32)) == 3
    if L < 32:
        assert (got[:2] == -1).all() and (got[2] == 0).all()
        return
    jkeys, jeb, _jv = jb.reads_to_records(jnp.asarray(bases), 32)
    words = (got[0].to(torch.int64) << 32) | (got[1].to(torch.int64)
                                              & 0xFFFFFFFF)
    np.testing.assert_array_equal(words.numpy().view(np.uint64),
                                  np.asarray(jkeys)[:, :lv, 0].reshape(-1))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(jeb)[:, :lv].reshape(-1))


@pytest.mark.parametrize("k", [15, 32, 63])
def test_epoch_planes_match_jax_count_batch(k):
    """_epoch's one tensor of planes (keys, count, edge) against JAX's
    count_batch of the same batch."""
    bases = _bases(700 + k, 16, 2 * k + 9)
    jk, jc, je, jn = jb.count_batch(jnp.asarray(bases), k, 1, 0)
    planes, n = tb._epoch(torch.from_numpy(bases), k)
    W = (2 * k + 63) // 64
    assert n == int(jn) > 0 and planes.shape == (2 * W + 2, jk.shape[0])
    np.testing.assert_array_equal(
        tb.kops.from_planes(planes[:2 * W]).numpy().view(np.uint64),
        np.asarray(jk))
    np.testing.assert_array_equal(planes[2 * W].numpy(),
                                  np.asarray(jc)[:, 0].view(np.int32))
    np.testing.assert_array_equal(planes[2 * W + 1].numpy(),
                                  np.asarray(je)[:, 0].astype(np.int32))


@pytest.mark.parametrize("k", [11, 31, 33, 63, 95])
def test_reads_to_records_matches_jax(k):
    bases = _bases(1000 + k, 12, 130)
    jkeys, jeb, jv = jb.reads_to_records(jnp.asarray(bases), k)
    tkeys, teb, tv = tb.reads_to_records(torch.from_numpy(bases), k)
    np.testing.assert_array_equal(tkeys.numpy().view(np.uint64),
                                  np.asarray(jkeys))
    np.testing.assert_array_equal(teb.numpy(), np.asarray(jeb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_records_rejects_unsupported_input():
    bases = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tfe.records_fused(bases, 65)
    with pytest.raises(ValueError):
        tfe.records_fused(bases.to(torch.int32), 31)
    with pytest.raises(ValueError):
        tfe.records_fused(bases.to("meta"), 31)

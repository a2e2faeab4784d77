"""The port's merge path (plain version, which CPU tensors take) against
the Pallas kernel mccortex_tpu.ops.pallas.mergepath.merge_path_planes in
interpret mode, and against a numpy stable lexsort at ragged lengths.
Key planes must match element for element; against the Pallas kernel,
which is not stable, payload planes match as a multiset per key.
Integer outputs: exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.ops.pallas import mergepath as jmp
from mccortex_tpu_torch.ops.kernels import mergepath as tmp


def _sorted_planes(rng, M, np_, nk, dup, sent_frac=0.0):
    hi = 50 if dup else 2**32
    n_sent = int(M * sent_frac)
    keys = rng.integers(0, hi, size=(nk, M - n_sent), dtype=np.uint64
                        ).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=(np_ - nk, M - n_sent),
                        dtype=np.uint64).astype(np.uint32)
    order = np.lexsort(keys[::-1])
    planes = np.concatenate([keys[:, order], vals[:, order]])
    tail = np.zeros((np_, n_sent), np.uint32)
    tail[:nk] = 0xFFFFFFFF
    return np.concatenate([planes, tail], axis=1)


def _by_record(planes):
    """Records sorted on every plane: a multiset view."""
    return planes[:, np.lexsort(planes[::-1])]


@pytest.mark.parametrize("Ma,Mb,np_,nk,dup", [
    (131072, 131072, 3, 2, False),
    (196608, 65536, 4, 2, True),
])
def test_matches_pallas_kernel(Ma, Mb, np_, nk, dup):
    rng = np.random.default_rng(Ma + Mb + np_)
    a = _sorted_planes(rng, Ma, np_, nk, dup, 0.1)
    b = _sorted_planes(rng, Mb, np_, nk, dup, 0.1)
    want = np.stack([np.asarray(x) for x in jmp.merge_path_planes(
        tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b),
        num_keys=nk, interpret=True)])
    got = tmp.merge_path_planes(torch.from_numpy(a.view(np.int32)),
                                torch.from_numpy(b.view(np.int32)), nk)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:nk], want[:nk])
    np.testing.assert_array_equal(_by_record(got), _by_record(want))


@pytest.mark.parametrize("Ma,Mb,np_,nk", [
    (1000, 1, 3, 2), (0, 777, 2, 1), (12345, 6789, 5, 4), (4097, 4095, 3, 3),
])
def test_ragged_lengths_match_stable_lexsort(Ma, Mb, np_, nk):
    rng = np.random.default_rng(Ma * 7 + Mb)
    a = _sorted_planes(rng, Ma, np_, nk, True, 0.05)
    b = _sorted_planes(rng, Mb, np_, nk, True, 0.05)
    both = np.concatenate([a, b], axis=1)
    want = both[:, np.lexsort(both[:nk][::-1])]        # stable: a first
    got = tmp.merge_path_planes(torch.from_numpy(a.view(np.int32)),
                                torch.from_numpy(b.view(np.int32)), nk)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_rejects_bad_arguments():
    a = torch.zeros((3, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        tmp.merge_path_planes(a, torch.zeros((2, 10), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        tmp.merge_path_planes(a, a, 4)
    with pytest.raises(ValueError):
        tmp.merge_path_planes(a.to(torch.int64), a.to(torch.int64), 2)

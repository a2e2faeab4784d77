"""The port's kmer codec (mccortex_tpu_torch.ops.kmer) against
mccortex_tpu.ops.kmer on the same numpy-seeded inputs.  Integer outputs:
exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.ops import kmer as jk
from mccortex_tpu_torch.ops import kmer as tk

KS = [9, 31, 33, 63, 95]


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k", KS)
def test_pack_revcmp_canonical(k):
    rng = np.random.default_rng(500 + k)
    bases = rng.integers(0, 4, size=(64, k)).astype(np.uint8)
    jp = np.asarray(jk.pack_kmers(jnp.asarray(bases), k))
    tp = tk.pack_kmers(torch.from_numpy(bases), k)
    np.testing.assert_array_equal(u64(tp), jp)
    np.testing.assert_array_equal(
        u64(tk.revcmp(tp, k)), np.asarray(jk.revcmp(jnp.asarray(jp), k)))
    jkey, jo = jk.canonical(jnp.asarray(jp), k)
    tkey, to = tk.canonical(tp, k)
    np.testing.assert_array_equal(u64(tkey), np.asarray(jkey))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("k", KS)
def test_rolling_kmers(k):
    rng = np.random.default_rng(600 + k)
    bases = rng.integers(0, 4, size=(6, 140)).astype(np.uint8)
    bases[rng.random(bases.shape) < 0.02] = 4
    bases[2, 70:] = 4                                  # a padded read
    jkm, jv = jk.rolling_kmers(jnp.asarray(bases), k)
    tkm, tv = tk.rolling_kmers(torch.from_numpy(bases), k)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.any()
    # words of windows that are not valid are unspecified in both
    np.testing.assert_array_equal(u64(tkm)[jv], np.asarray(jkm)[jv])


def test_rolling_kmers_read_shorter_than_k():
    bases = np.zeros((3, 20), np.uint8)
    kmers, valid = tk.rolling_kmers(torch.from_numpy(bases), 31)
    assert kmers.shape == (3, 20, 1) and not valid.any()


@pytest.mark.parametrize("W", [1, 2, 3])
def test_multiword_helpers(W):
    rng = np.random.default_rng(700 + W)
    a = rng.integers(0, 2**64, size=(300, W), dtype=np.uint64)
    b = a.copy()
    b[::3] = rng.integers(0, 2**64, size=b[::3].shape, dtype=np.uint64)
    b[1::3, 0] ^= np.uint64(1 << 63)                   # differ in the top bit
    for nbits in (0, 2, 30, 63, 64, 70, 130, 200):
        np.testing.assert_array_equal(
            u64(tk.mw_shift_left(t64(a), nbits)),
            np.asarray(jk.mw_shift_left(jnp.asarray(a), nbits)))
        np.testing.assert_array_equal(
            u64(tk.mw_shift_right(t64(a), nbits)),
            np.asarray(jk.mw_shift_right(jnp.asarray(a), nbits)))
    for fn in ("mw_lt", "mw_eq", "mw_min"):
        got = getattr(tk, fn)(t64(a), t64(b)).numpy()
        want = np.asarray(getattr(jk, fn)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got.view(want.dtype), want)


@pytest.mark.parametrize("W", [1, 2, 3])
def test_planes_roundtrip(W):
    rng = np.random.default_rng(800 + W)
    words = rng.integers(0, 2**64, size=(257, W), dtype=np.uint64)
    planes = tk.to_planes(t64(words))
    assert planes.shape == (2 * W, 257) and planes.dtype == torch.int32
    p = planes.numpy().view(np.uint32)
    np.testing.assert_array_equal(p[0], (words[:, 0] >> np.uint64(32)))
    np.testing.assert_array_equal(p[2 * W - 1], words[:, W - 1].astype(
        np.uint32))
    np.testing.assert_array_equal(u64(tk.from_planes(planes)), words)

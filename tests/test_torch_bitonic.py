"""The port's bitonic sort and merge (plain versions, which CPU tensors
take, at small tiles) against mccortex_tpu.ops.pallas.bitonic in
interpret mode at a small block, and against a numpy stable lexsort.

Tie contract: key planes equal a stable sort's element for element;
whole records are the same multiset within every run of equal keys
(checked by a lexsort over all planes).  block_sort alone is stable: an
ascending tile equals the stable sort on every plane.  Integer outputs:
exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.ops.pallas import bitonic as jbt
from mccortex_tpu_torch.ops.kernels import bitonic as tbt

R_TEST = 8                         # JAX block: 8 rows of 128 lanes
BLK_TEST = R_TEST * jbt.LANES


def _planes(rng, M, np_, nk, dup=False, sent_frac=0.0):
    hi = 7 if dup else 2**32
    keys = rng.integers(0, hi, size=(nk, M), dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=(np_ - nk, M),
                        dtype=np.uint64).astype(np.uint32)
    sent = rng.random(M) < sent_frac
    keys[:, sent] = 0xFFFFFFFF
    return np.concatenate([keys, vals])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


def _stable(planes, nk):
    return planes[:, np.lexsort(planes[:nk][::-1])]


def _by_record(planes):
    return planes[:, np.lexsort(planes[::-1])]


def _same_up_to_ties(got, want, nk):
    np.testing.assert_array_equal(got[:nk], want[:nk])
    np.testing.assert_array_equal(_by_record(got), _by_record(want))


def _jax_sort(planes, nk):
    return np.stack([np.asarray(x) for x in jbt.sort_planes(
        tuple(jnp.asarray(p) for p in planes), num_keys=nk, r_blk=R_TEST,
        interpret=True)])


@pytest.mark.parametrize("nb,np_,nk,tile", [
    (1, 1, 1, 1024), (1, 3, 2, 256), (2, 3, 2, 1024), (4, 2, 1, 64),
    (8, 3, 2, 1024), (4, 5, 4, 512)])
def test_sort_planes_matches_jax(nb, np_, nk, tile):
    rng = np.random.default_rng(100 * nb + np_)
    planes = _planes(rng, nb * BLK_TEST, np_, nk)
    got = _u(tbt.sort_planes(_t(planes), nk, tile=tile))
    _same_up_to_ties(got, _jax_sort(planes, nk), nk)
    _same_up_to_ties(got, _stable(planes, nk), nk)


@pytest.mark.parametrize("case", ["dups_and_sentinels", "all_equal",
                                  "padded"])
def test_sort_planes_ties_and_padding(case):
    rng = np.random.default_rng(7)
    M = 4 * BLK_TEST
    if case == "all_equal":
        planes = _planes(rng, M, 2, 1)
        planes[0] = 0xABCD1234
    elif case == "padded":
        live = _planes(rng, M - 700, 3, 2, dup=True, sent_frac=0.05)
        # sentinel-key records carry no payload in the build
        live[2, (live[:2] == 0xFFFFFFFF).all(axis=0)] = 0
        padded = _u(tbt.pad_planes(_t(live), 2, tbt.padded_length(M - 700,
                                                                  64)))
        assert padded.shape[1] == M
        assert (padded[:2, M - 700:] == 0xFFFFFFFF).all()
        assert (padded[2, M - 700:] == 0).all()
        planes = padded
    else:
        planes = _planes(rng, M, 3, 2, dup=True, sent_frac=0.3)
    nk = 1 if case == "all_equal" else 2
    got = _u(tbt.sort_planes(_t(planes), nk, tile=64))
    _same_up_to_ties(got, _jax_sort(planes, nk), nk)
    if case == "padded":
        # the sorted live records are the prefix
        _same_up_to_ties(got[:, :M - 700], _stable(live, nk), nk)


@pytest.mark.parametrize("nb_half,np_,nk,tile", [
    (1, 3, 2, 1024), (2, 3, 2, 128), (4, 2, 1, 1024), (2, 6, 4, 2048)])
def test_merge_planes_matches_jax(nb_half, np_, nk, tile):
    rng = np.random.default_rng(50 + nb_half)
    Mh = nb_half * BLK_TEST
    a = _stable(_planes(rng, Mh, np_, nk, dup=True, sent_frac=0.1), nk)
    b = _stable(_planes(rng, Mh, np_, nk, dup=True, sent_frac=0.2), nk)
    want = np.stack([np.asarray(x) for x in jbt.merge_planes(
        tuple(jnp.asarray(p) for p in a), tuple(jnp.asarray(p) for p in b),
        num_keys=nk, r_blk=R_TEST, interpret=True)])
    got = _u(tbt.merge_planes(_t(a), _t(b), nk, tile=tile))
    _same_up_to_ties(got, want, nk)
    _same_up_to_ties(got, _stable(np.concatenate([a, b], axis=1), nk), nk)


@pytest.mark.parametrize("M,tile,all_asc", [
    (1, 16, True), (15, 16, True), (17, 16, True), (3 * 16 + 5, 16, True),
    (64, 16, False), (16, 16, False), (9, 16, False), (256, 32, False)])
def test_block_sort_is_stable_per_tile(M, tile, all_asc):
    rng = np.random.default_rng(M)
    planes = _planes(rng, M, 4, 2, dup=True, sent_frac=0.2)
    got = _u(tbt.block_sort(_t(planes), 2, all_asc=all_asc, tile=tile))
    for t, s in enumerate(range(0, M, tile)):
        want = _stable(planes[:, s:s + tile], 2)
        if not all_asc and t % 2:
            want = want[:, ::-1]
        np.testing.assert_array_equal(got[:, s:s + tile], want)


def test_tail_and_butterfly_follow_the_network():
    # one merge stage by hand: butterflies down to the tile, then the tail,
    # sorts a bitonic input; equal keys never swap
    rng = np.random.default_rng(3)
    tile, M = 16, 128
    a = _stable(_planes(rng, M // 2, 3, 2, dup=True), 2)
    b = _stable(_planes(rng, M // 2, 3, 2, dup=True), 2)[:, ::-1]
    sp = _t(np.concatenate([a, b], axis=1))
    j = M // 2
    while j >= tile:
        sp = tbt.butterfly(sp, 2, j, M, True)
        j //= 2
    got = _u(tbt.tail(sp, 2, M, True, tile=tile))
    _same_up_to_ties(got, _stable(np.concatenate([a, b], axis=1), 2), 2)
    same = _t(np.tile(np.array([[5], [5], [0]], np.uint32), (1, 32)))
    same[2] = torch.arange(32, dtype=torch.int32)
    out = tbt.tail(same, 2, 32, False, tile=16)
    assert torch.equal(out, same)
    # stage k = 32 over 64 records: the first 32 leave ascending, the
    # second 32 descending
    q = [_stable(_planes(rng, 16, 3, 2, dup=True), 2) for _ in range(4)]
    x = np.concatenate([q[0], q[1][:, ::-1], q[2], q[3][:, ::-1]], axis=1)
    got = _u(tbt.tail(tbt.butterfly(_t(x), 2, 16, 32, False), 2, 32, False,
                      tile=16))
    _same_up_to_ties(got[:, :32], _stable(x[:, :32], 2), 2)
    _same_up_to_ties(got[:, :31:-1], _stable(x[:, 32:], 2), 2)


@pytest.mark.parametrize("nb,np_,nk,tile", [
    (1, 3, 2, 256), (2, 3, 2, 512), (4, 2, 1, 64), (4, 5, 4, 512),
    (1, 2, 1, 512)])
def test_sort_planes_with_a_tail_of_two_tiles_matches_jax(nb, np_, nk, tile):
    """The tail over spans of two tiles takes one butterfly out of every
    stage: the same compare-exchanges, so the same bytes."""
    rng = np.random.default_rng(200 * nb + np_)
    planes = _planes(rng, nb * BLK_TEST, np_, nk, dup=nb == 4,
                     sent_frac=0.1 * (nb == 2))
    got = tbt.sort_planes_plain(_t(planes), nk, tile, span=2 * tile)
    assert torch.equal(got, tbt.sort_planes_plain(_t(planes), nk, tile))
    assert torch.equal(got, tbt.sort_planes(_t(planes), nk, tile=tile))
    _same_up_to_ties(_u(got), _jax_sort(planes, nk), nk)


@pytest.mark.parametrize("nb_half,np_,nk,tile", [
    (1, 3, 2, 1024), (2, 3, 2, 128), (2, 6, 4, 2048)])
def test_merge_planes_with_a_tail_of_two_tiles_matches_jax(nb_half, np_, nk,
                                                           tile):
    rng = np.random.default_rng(60 + nb_half)
    Mh = nb_half * BLK_TEST
    a = _stable(_planes(rng, Mh, np_, nk, dup=True, sent_frac=0.1), nk)
    b = _stable(_planes(rng, Mh, np_, nk, dup=True, sent_frac=0.2), nk)
    want = np.stack([np.asarray(x) for x in jbt.merge_planes(
        tuple(jnp.asarray(p) for p in a), tuple(jnp.asarray(p) for p in b),
        num_keys=nk, r_blk=R_TEST, interpret=True)])
    got = tbt.merge_planes_plain(_t(a), _t(b), nk, tile, span=2 * tile)
    assert torch.equal(got, tbt.merge_planes_plain(_t(a), _t(b), nk, tile))
    _same_up_to_ties(_u(got), want, nk)


@pytest.mark.parametrize("k,final_asc,nk", [(32, False, 2), (64, False, 1),
                                            (128, True, 3), (32, True, 2)])
def test_tail_of_two_tiles_is_a_butterfly_and_a_tail(k, final_asc, nk):
    rng = np.random.default_rng(k + nk)
    tile, M = 16, 128
    x = _t(_planes(rng, M, nk + 1, nk, dup=True, sent_frac=0.1))
    got = tbt.tail(x, nk, k, final_asc, tile=2 * tile)
    want = tbt.tail(tbt.butterfly(x, nk, tile, k, final_asc), nk, k,
                    final_asc, tile=tile)
    assert torch.equal(got, want)
    same = x.clone()
    same[:nk] = 7                                 # equal keys never swap
    assert torch.equal(tbt.tail(same, nk, k, final_asc, tile=2 * tile), same)


def test_rejects_bad_arguments():
    x = torch.zeros((3, 48), dtype=torch.int32)
    with pytest.raises(ValueError):
        tbt.sort_planes(x, 2, tile=16)            # 48 is not a power of two
    with pytest.raises(ValueError):
        tbt.sort_planes(x.to(torch.int64), 2, tile=16)
    with pytest.raises(ValueError):
        tbt.sort_planes(x, 4, tile=16)            # more keys than planes
    with pytest.raises(ValueError):
        tbt.block_sort(x[:, :40], 2, all_asc=False, tile=16)
    with pytest.raises(ValueError):
        tbt.merge_planes(x[:, :32], x[:, :16], 2, tile=16)
    with pytest.raises(ValueError):
        tbt.merge_planes(x[:, :8], x[:, :8], 2, tile=16)
    with pytest.raises(ValueError):
        tbt.tail(x, 2, 24, True, tile=16)
    with pytest.raises(ValueError):
        tbt.sort_planes_plain(x[:, :32], 2, 16, span=64)
    with pytest.raises(ValueError):
        tbt.tail(x[:, :32], 2, 16, True, tile=32)  # the stage is below the span
    many = torch.zeros((12, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        tbt.sort_planes(many, 10, tile=16)        # MAX_KEYS is 9
    assert tbt.sort_planes(many, 9, tile=16).shape == (12, 16)

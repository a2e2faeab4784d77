"""The 128-byte-row table built on the card (csrc/lookup.cu `mctx_table32`,
ops/kernels/lookup.build_table32_fused) against numpy's build_table32, byte
for byte.  On the CPU: the kernels compiled by scripts/cuda_emul (host
threads for CUDA threads) behind the wrapper's own launcher, and the CPU
path of ops/hashidx, which builds through numpy.  The `gpu` cases hold the
card's tables to numpy's at a few million keys; they skip without a card.
Torch and numpy only:

    python -m pytest --noconftest -m gpu tests/test_torch_table_kernel.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mccortex_tpu_torch.ops import hashidx
from mccortex_tpu_torch.ops import kmer as kops
from mccortex_tpu_torch.ops.kernels import _build, lookup
from mccortex_tpu_torch.utils import timing

import table_cases as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emulate():
    spec = importlib.util.spec_from_file_location(
        "emulate", os.path.join(ROOT, "scripts", "cuda_emul", "emulate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return _emulate(), str(tmp_path_factory.mktemp("emu"))


@pytest.fixture(scope="module", params=["as written", "ranks reversed"])
def emulated(request, emulator):
    """The emulator module and the table build's C entry points built by
    g++ for the CPU: as written, and with the histogram's ranks handed out
    from the last key to the first, so that every bucket arrives reversed
    (the card hands them out in no set order)."""
    mod, tmp = emulator
    return mod, mod.table_fns(tmp, request.param == "ranks reversed")


def _layout(table, keys, b_bits):
    """(row, home row) of every stored key, and the fill of every row."""
    W = keys.shape[1]
    S = lookup.slots_for(W, lookup.ROW32)
    idx = table[:, 2 * W * S:(2 * W + 1) * S]
    row, slot = np.nonzero(idx != 0xFFFFFFFF)
    home = (kops.kmer_hash_np(keys) >> np.uint64(64 - b_bits)).astype(
        np.int64)[idx[row, slot].astype(np.int64)]
    return row, home, (idx != 0xFFFFFFFF).sum(axis=1), S


@pytest.mark.parametrize("case", list(tc.CASES))
def test_table_kernel_on_the_cpu_matches_numpy(emulated, case):
    """The launcher as it is, its kernels compiled for the CPU: the same
    bytes and b_bits as build_table32, in as many rounds, one launch a
    round."""
    emu, fns = emulated
    W, n, b_bits, extra = tc.CASES[case]
    keys = tc.keys_of(W, n, b_bits, extra)
    want, wb = lookup.build_table32(keys, b_bits=b_bits)
    n0 = _build.LAUNCHES["table"]
    got, gb, rounds = emu.table_on_cpu(fns, keys, b_bits)
    assert gb == wb and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert rounds == tc.rounds_of(want, keys, wb)
    assert _build.LAUNCHES["table"] == n0 + rounds
    row, home, fill, S = _layout(want, keys, wb)
    if extra:       # the last row overflows its register sort and wraps
        assert (home == (1 << wb) - 1).sum() > 16 and (row < home).any()
    if n + extra == S << wb:
        assert (fill == S).all()


def test_cpu_keys_build_through_numpy(monkeypatch):
    """On a CPU store the table is numpy's build_table32 of the live
    prefix, counted in table.keys and in no card counter."""
    keys_np = tc.keys_of(2, 500, None, 0)
    keys = torch.from_numpy(np.concatenate(
        [keys_np, np.full((12, 2), np.uint64(2**64 - 1))]).view(np.int64))
    calls = []
    real = lookup.build_table32

    def spy(live, *a, **kw):
        calls.append(len(live))
        return real(live, *a, **kw)

    monkeypatch.setattr(lookup, "build_table32", spy)
    timing.reset()
    table, bb = hashidx.get_index32_for(keys)
    assert calls == [500]
    assert dict(timing.COUNTERS) == {"table.keys": 500}
    want, wb = real(keys_np)
    assert bb == wb and table.device.type == "cpu"
    np.testing.assert_array_equal(table.numpy().view(np.uint32), want)


def test_build_table32_fused_refuses_cpu_keys_and_bad_shapes():
    keys = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA keys"):
        lookup.build_table32_fused(keys)
    for bad in (torch.zeros((4, 5), dtype=torch.int64),
                torch.zeros(4, dtype=torch.int64),
                torch.zeros((4, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="int64 words"):
            lookup.build_table32_fused(bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (W, n, b_bits, extra): the default geometry at a few million keys, and a
# crowded table of long chains that wrap past the last row
CARD_CASES = [(1, 3_000_000, None, 0), (2, 2_000_000, None, 0),
              (3, 600_000, None, 0), (4, 500_000, None, 0),
              (1, 1_200_000, 17, 40), (2, 740_000, 17, 40),
              (4, 380_000, 17, 40), (1, 0, None, 0), (2, 1, None, 0),
              (1, 10 << 10, 10, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("W,n,b_bits,extra", CARD_CASES)
def test_table_kernel_on_card_matches_numpy(cuda, W, n, b_bits, extra):
    keys = tc.keys_of(W, n, b_bits, extra)
    want, wb = lookup.build_table32(keys, b_bits=b_bits)
    n0 = _build.LAUNCHES["table"]
    table, bb, rounds = lookup.build_table32_fused(
        torch.from_numpy(keys.view(np.int64)).to(cuda), b_bits)
    torch.cuda.synchronize()
    assert bb == wb and table.device.type == "cuda"
    np.testing.assert_array_equal(table.cpu().numpy().view(np.uint32), want)
    assert rounds == tc.rounds_of(want, keys, wb)
    assert _build.LAUNCHES["table"] == n0 + rounds


@pytest.mark.gpu
def test_card_store_builds_its_table_on_the_card(cuda):
    """get_index32_for on a CUDA store: the table built on the card
    (table.card, table.rounds), the same bytes as numpy's of the live
    prefix, and the lookups through it exact."""
    keys_np = tc.keys_of(1, 400_000, None, 0)
    keys = torch.from_numpy(np.concatenate(
        [keys_np, np.full((1000, 1), np.uint64(2**64 - 1))]).view(
            np.int64)).to(cuda)
    timing.reset()
    table, bb = hashidx.get_index32_for(keys)
    want, wb = lookup.build_table32(keys_np)
    c = dict(timing.COUNTERS)
    assert c == {"table.card": 1, "table.rounds": tc.rounds_of(want, keys_np,
                                                               wb),
                 "table.keys": len(keys_np)}
    assert bb == wb
    np.testing.assert_array_equal(table.cpu().numpy().view(np.uint32), want)
    q = keys[torch.randperm(keys.shape[0], device=cuda)[:50_000]]
    idx, found = hashidx.lookup(keys, q)
    live = ~hashidx.sops.is_sentinel(q)
    assert torch.equal(found, live)
    assert torch.equal(keys[idx[found].long()], q[found])

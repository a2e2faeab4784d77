"""Key sets for the table kernel (csrc/lookup.cu `mctx_table32`), shared by
tests/test_torch_table_kernel.py and scripts/cuda_emul/emulate.py.  Torch
and numpy only.

A case is (W, n, b_bits, extra): n random live keys of W words, plus
`extra` keys whose home row is the last one, so that row overflows past
its 16-key register sort and its chain wraps past row B - 1 to row 0.  A
given b_bits far below the default crowds the table into chains of many
rows; n = B x S leaves no empty slot.
"""

import numpy as np

from mccortex_tpu_torch.ops import kmer as kops
from mccortex_tpu_torch.ops.kernels import lookup

CASES = {
    "ragged, W=1": (1, 2999, None, 0),
    "ragged, W=2": (2, 1999, None, 0),
    "ragged, W=3": (3, 1001, None, 0),
    "ragged, W=4": (4, 700, None, 0),
    "no keys, W=1": (1, 0, None, 0),
    "no keys, W=4": (4, 0, None, 0),
    "one key, W=1": (1, 1, None, 0),
    "one key, W=2": (2, 1, None, 0),
    "chains that wrap, W=1": (1, 2200, 8, 30),
    "chains that wrap, W=2": (2, 1300, 8, 20),
    "chains that wrap, W=4": (4, 620, 8, 20),
    "no empty slot, W=1": (1, 40, 2, 0),
    "no empty slot, W=2": (2, 24, 2, 0),
    "no empty slot, W=4": (4, 384, 7, 0),
}


def keys_of(W: int, n: int, b_bits, extra: int, seed: int = 0) -> np.ndarray:
    """Sorted unique (n + extra, W) uint64 keys, word 0 below 2**62 (a
    valid kmer's top word is never all ones)."""
    rng = np.random.default_rng(seed + 1000 * W + n)
    keys = np.unique(rng.integers(0, 1 << 62, size=(n + 64, W),
                                  dtype=np.uint64), axis=0)
    keys = keys[rng.permutation(len(keys))[:n]]
    if extra:
        B = 1 << b_bits
        pool = rng.integers(0, 1 << 62, size=(4 * extra * B, W),
                            dtype=np.uint64)
        pool = pool[kops.kmer_hash_np(pool) >> np.uint64(64 - b_bits)
                    == B - 1][:extra]
        assert len(pool) == extra
        keys = np.concatenate([keys, pool])
    out = np.unique(keys, axis=0)
    assert len(out) == n + extra
    return out


def rounds_of(table: np.ndarray, keys: np.ndarray, b_bits: int) -> int:
    """build_table32's rounds: a key stored d rows past its home row was
    placed in round d + 1.  A table of no keys takes one launch."""
    if len(keys) == 0:
        return 1
    W = keys.shape[1]
    S = lookup.slots_for(W, lookup.ROW32)
    idx = table[:, 2 * W * S:(2 * W + 1) * S]
    row, _slot = np.nonzero(idx != 0xFFFFFFFF)
    store = idx[row, _slot].astype(np.int64)
    home = (kops.kmer_hash_np(keys) >> np.uint64(64 - b_bits)).astype(
        np.int64)[store]
    return int(((row - home) % (1 << b_bits)).max()) + 1

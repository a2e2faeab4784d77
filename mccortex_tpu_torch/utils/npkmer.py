"""Pure-numpy binary-kmer codec on the host; copy of
mccortex_tpu/utils/npkmer.py (which cannot be imported without jax).

For data too small to amortise a device call, where a Python per-kmer
loop would dominate at scale.  Layout is identical to ops/kmer.py: (N,
W) uint64 (ops/kmer.py holds the same words as int64 bit views), word 0
most significant, low 2k bits used, canonical = lexicographic
min(fwd, revcmp).
"""

from __future__ import annotations

import numpy as np

from ..constants import nwords, CHAR_TO_BASE

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)


def seq_to_codes_np(seq: str) -> np.ndarray:
    return CHAR_TO_BASE[np.frombuffer(seq.encode(), np.uint8)]


def rolling_kmers_np(codes: np.ndarray, k: int):
    """All kmers of a code array: (N, W) uint64 + valid mask (N,).
    Windows containing invalid codes (>= 4) are marked invalid (their
    packed value is garbage)."""
    L = codes.shape[0]
    W = nwords(k)
    N = max(0, L - k + 1)
    if N == 0:
        return np.zeros((0, W), np.uint64), np.zeros(0, bool)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)  # (N, k)
    valid = (win < 4).all(axis=1)
    win64 = (win & 3).astype(np.uint64)
    out = np.zeros((N, W), np.uint64)
    # base j sits at bit 2*(k-1-j) of the big-endian 2k-bit number
    bitpos = 2 * (k - 1 - np.arange(k))
    word = W - 1 - bitpos // 64
    shift = (bitpos % 64).astype(np.uint64)
    for w in range(W):
        sel = np.nonzero(word == w)[0]
        vals = win64[:, sel] << shift[sel]
        out[:, w] = np.bitwise_or.reduce(vals, axis=1)
    return out, valid


def _rev2bits_word(x: np.ndarray) -> np.ndarray:
    x = ((x & _M2) << np.uint64(2)) | ((x >> np.uint64(2)) & _M2)
    x = ((x & _M4) << np.uint64(4)) | ((x >> np.uint64(4)) & _M4)
    x = ((x & _M8) << np.uint64(8)) | ((x >> np.uint64(8)) & _M8)
    x = ((x & _M16) << np.uint64(16)) | ((x >> np.uint64(16)) & _M16)
    return (x << np.uint64(32)) | (x >> np.uint64(32))


def _mw_shift_right_np(x: np.ndarray, nbits: int) -> np.ndarray:
    W = x.shape[-1]
    word_sh, bit_sh = nbits // 64, nbits % 64
    if word_sh:
        pad = np.zeros(x.shape[:-1] + (word_sh,), np.uint64)
        x = np.concatenate([pad, x[..., :W - word_sh]], axis=-1)
    if bit_sh:
        lo = x >> np.uint64(bit_sh)
        hi_in = np.concatenate(
            [np.zeros(x.shape[:-1] + (1,), np.uint64), x[..., :-1]],
            axis=-1)
        x = lo | (hi_in << np.uint64(64 - bit_sh))
    return x


def revcmp_np(kmers: np.ndarray, k: int) -> np.ndarray:
    W = kmers.shape[-1]
    y = ~kmers
    y = _rev2bits_word(y)
    y = y[..., ::-1]
    return _mw_shift_right_np(y, 64 * W - 2 * k)


def canonical_np(kmers: np.ndarray, k: int):
    """(key, orient): key = min(kmer, revcmp); orient=1 iff revcmp won."""
    rc = revcmp_np(kmers, k)
    W = kmers.shape[-1]
    lt = rc[..., W - 1] < kmers[..., W - 1]
    for w in range(W - 2, -1, -1):
        lt = (rc[..., w] < kmers[..., w]) | \
            ((rc[..., w] == kmers[..., w]) & lt)
    key = np.where(lt[..., None], rc, kmers)
    return key, lt.astype(np.uint8)


def seq_canonical_keys(seq: str, k: int):
    """Canonical keys + orient + positions of all valid kmers of a
    string.  Returns (keys (n, W) u64, orient (n,) u8, pos (n,) i64)."""
    codes = seq_to_codes_np(seq)
    kmers, valid = rolling_kmers_np(codes, k)
    keys, orient = canonical_np(kmers, k)
    pos = np.nonzero(valid)[0]
    return keys[valid], orient[valid], pos

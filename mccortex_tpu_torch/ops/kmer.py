"""Binary-kmer codec on int64 words (plain PyTorch).

Counterpart of mccortex_tpu/ops/kmer.py.  A k-mer is 2-bit packed into
W = ceil(2k/64) words, laid out like the reference BinaryKmer: word 0
is the most significant, the kmer occupies the LOW 2k bits of the
W*64-bit big-endian number, first base at the top.  Words are int64 bit
views of the uint64 words: unsigned order is the signed order of
`x ^ SIGN`, and right shifts are made logical by masking.

Every function works on any device; the word axis W is always last.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import nwords

SIGN = -(1 << 63)        # int64 bit pattern of 1 << 63
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words by a static s."""
    if s == 0:
        return x
    if s >= 64:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (64 - s)) - 1)


def _zeros_words(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# multiword helpers: tensors of shape (..., W), word 0 most significant
# ---------------------------------------------------------------------------

def mw_shift_left(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Shift the multiword integer left by a static number of bits."""
    W = x.shape[-1]
    word_sh, bit_sh = divmod(nbits, 64)
    if word_sh >= W:
        return torch.zeros_like(x)
    if word_sh:
        x = torch.cat([x[..., word_sh:], _zeros_words(x, word_sh)], dim=-1)
    if bit_sh:
        lo_in = torch.cat([x[..., 1:], _zeros_words(x, 1)], dim=-1)
        x = (x << bit_sh) | srl(lo_in, 64 - bit_sh)
    return x


def mw_shift_right(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Shift the multiword integer right by a static number of bits."""
    W = x.shape[-1]
    word_sh, bit_sh = divmod(nbits, 64)
    if word_sh >= W:
        return torch.zeros_like(x)
    if word_sh:
        x = torch.cat([_zeros_words(x, word_sh), x[..., :-word_sh]], dim=-1)
    if bit_sh:
        hi_in = torch.cat([_zeros_words(x, 1), x[..., :-1]], dim=-1)
        x = srl(x, bit_sh) | (hi_in << (64 - bit_sh))
    return x


def mw_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned lexicographic a < b over the trailing word axis."""
    W = a.shape[-1]
    fa, fb = a ^ SIGN, b ^ SIGN
    lt = fa[..., W - 1] < fb[..., W - 1]
    for w in range(W - 2, -1, -1):
        lt = (fa[..., w] < fb[..., w]) | ((a[..., w] == b[..., w]) & lt)
    return lt


def mw_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def mw_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mw_lt(a, b)[..., None], a, b)


def to_planes(words: torch.Tensor) -> torch.Tensor:
    """(M, W) int64 words -> (2W, M) int32 limb planes, most significant
    first (the layout the kernels take)."""
    hi = (words >> 32).to(torch.int32)
    lo = words.to(torch.int32)
    planes = torch.stack([hi, lo], dim=-1).reshape(-1, 2 * words.shape[-1])
    return planes.T.contiguous()


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(2W, M) int32 limb planes, most significant first -> (M, W) int64
    words."""
    p = planes.to(torch.int64)
    return ((p[0::2] << 32) | (p[1::2] & 0xFFFFFFFF)).T.contiguous()


# ---------------------------------------------------------------------------
# pack / reverse complement / canonical key
# ---------------------------------------------------------------------------

def pack_kmers(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Pack base codes (..., k) uint8 -> (..., W) int64 kmers;
    bases[..., 0] is the first (most significant) base."""
    W = nwords(k)
    batch = bases.shape[:-1]
    b = (bases & 3).to(torch.int64)
    pad = W * 32 - k
    if pad:
        b = torch.cat([torch.zeros(batch + (pad,), dtype=torch.int64,
                                   device=b.device), b], dim=-1)
    v = b.reshape(batch + (W, 32))
    out = torch.zeros(batch + (W,), dtype=torch.int64, device=b.device)
    for t in range(32):
        out = (out << 2) | v[..., t]
    return out


def _rev2bits_word(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of 2-bit groups within each word."""
    x = ((x & _M2) << 2) | (srl(x, 2) & _M2)
    x = ((x & _M4) << 4) | (srl(x, 4) & _M4)
    x = ((x & _M8) << 8) | (srl(x, 8) & _M8)
    x = ((x & _M16) << 16) | (srl(x, 16) & _M16)
    return (x << 32) | srl(x, 32)


def revcmp(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement: complement every base (bitwise NOT), reverse
    the base order across the W*64-bit number, shift back down into
    the low 2k bits."""
    W = kmers.shape[-1]
    y = torch.flip(_rev2bits_word(~kmers), dims=(-1,))
    return mw_shift_right(y, 64 * W - 2 * k)


def canonical(kmers: torch.Tensor, k: int):
    """(key, orient): key = min(kmer, revcmp(kmer)); orient == 1 iff the
    reverse complement is the key.  k odd => the two never tie."""
    rc = revcmp(kmers, k)
    rc_is_key = mw_lt(rc, kmers)
    key = torch.where(rc_is_key[..., None], rc, kmers)
    return key, rc_is_key.to(torch.uint8)


def oriented(keys: torch.Tensor, orient: torch.Tensor, k: int) -> torch.Tensor:
    """Kmer as read in the given orientation: key if FORWARD else revcmp."""
    rc = revcmp(keys, k)
    return torch.where(orient[..., None].to(torch.bool), rc, keys)


def first_base(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Most significant (first) base of each kmer, uint8."""
    off = 2 * (k - 1)
    w = kmers.shape[-1] - 1 - off // 64
    return (srl(kmers[..., w], off % 64) & 3).to(torch.uint8)


def shift_append(kmers: torch.Tensor, base: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """kmer<<2 | base, masked to 2k bits."""
    y = mw_shift_left(kmers, 2)
    y[..., -1] |= base.to(torch.int64)
    return _mask_topbits(y, k)


def _mask_topbits(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Zero any bits above 2k."""
    W = kmers.shape[-1]
    top_bits = 2 * k - 64 * (W - 1)
    mask = (1 << top_bits) - 1 if top_bits < 64 else -1
    y = kmers.clone()
    y[..., 0] &= mask
    return y


# ---------------------------------------------------------------------------
# hashing: splitmix64 finaliser on int64 bit views (multiplication and
# addition wrap modulo 2**64 like uint64)
# ---------------------------------------------------------------------------

def _i64(v: int) -> int:
    """Signed int64 bit pattern of an unsigned 64-bit constant."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


_GOLD = _i64(0x9E3779B97F4A7C15)
_SM_C1 = _i64(0xBF58476D1CE4E5B9)
_SM_C2 = _i64(0x94D049BB133111EB)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _GOLD
    x = (x ^ srl(x, 30)) * _SM_C1
    x = (x ^ srl(x, 27)) * _SM_C2
    return x ^ srl(x, 31)


def kmer_hash(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """64-bit hash of packed kmers (..., W) -> (...,) int64 bit views;
    equal bit for bit to mccortex_tpu.ops.kmer.kmer_hash."""
    W = keys.shape[-1]
    h = splitmix64(keys[..., 0] ^ _i64(seed * 0x9E3779B97F4A7C15))
    for w in range(1, W):
        h = splitmix64(h ^ keys[..., w])
    return h


def kmer_hash_np(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Host mirror of kmer_hash on (n, W) uint64 keys (must match bit
    for bit)."""
    gold = np.uint64(0x9E3779B97F4A7C15)
    c1 = np.uint64(0xBF58476D1CE4E5B9)
    c2 = np.uint64(0x94D049BB133111EB)

    def sm(x):
        with np.errstate(over="ignore"):
            x = x + gold
            x = (x ^ (x >> np.uint64(30))) * c1
            x = (x ^ (x >> np.uint64(27))) * c2
            return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        h = sm(keys[:, 0] ^ (np.uint64(seed) * gold))
        for w in range(1, keys.shape[1]):
            h = sm(h ^ keys[:, w])
    return h


def query_planes(q: torch.Tensor):
    """(Q, W) int64 words -> 2W (Q,) int32 limbs [w0_hi, w0_lo, ...]."""
    out = []
    for w in range(q.shape[1]):
        out.append((q[:, w] >> 32).to(torch.int32))
        out.append(q[:, w].to(torch.int32))
    return out


# ---------------------------------------------------------------------------
# rolling extraction
# ---------------------------------------------------------------------------

def rolling_kmers(bases: torch.Tensor, k: int):
    """Every kmer of every read.

    bases (..., L) uint8 codes, 4 = invalid/pad.  Returns (kmers
    (..., L, W) int64, valid (..., L) bool): kmers[..., i, :] is the
    window starting at i; valid marks windows inside the read with no
    invalid base.  Windows that are not valid hold unspecified words.
    """
    L = bases.shape[-1]
    W = nwords(k)
    batch = bases.shape[:-1]
    dev = bases.device
    if L < k:   # every window falls off the end
        return (torch.zeros(batch + (L, W), dtype=torch.int64, device=dev),
                torch.zeros(batch + (L,), dtype=torch.bool, device=dev))
    kmers = pack_kmers(bases.unfold(-1, k, 1), k)      # (..., L-k+1, W)
    bad = (bases >= 4).to(torch.int32).unfold(-1, k, 1).sum(dim=-1) > 0
    tail = k - 1
    kmers = torch.cat([kmers, torch.zeros(batch + (tail, W),
                                          dtype=torch.int64, device=dev)],
                      dim=-2)
    valid = torch.cat([~bad, torch.zeros(batch + (tail,), dtype=torch.bool,
                                         device=dev)], dim=-1)
    return kmers, valid

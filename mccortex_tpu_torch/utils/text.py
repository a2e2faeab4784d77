"""Host-side text conversions for kmers and edges (numpy, no device).
Copies of kmers_to_strings, strings_to_kmers and edges_to_strings in
mccortex_tpu/utils/text.py; tests hold the two equal."""

from __future__ import annotations

import numpy as np

_CHARS = np.frombuffer(b"ACGT", np.uint8)


def kmers_to_strings(keys: np.ndarray, k: int) -> list:
    """(N, W) uint64 -> list of kmer strings."""
    N, W = keys.shape
    offs = 2 * (k - 1 - np.arange(k))
    widx = W - 1 - offs // 64
    sh = (offs % 64).astype(np.uint64)
    codes = ((keys[:, widx] >> sh) & np.uint64(3)).astype(np.uint8)
    chars = _CHARS[codes]
    return [bytes(row).decode() for row in chars]


def strings_to_kmers(strs, W: int) -> np.ndarray:
    """List of kmer strings -> (n, W) uint64 packed kmers."""
    from ..constants import CHAR_TO_BASE
    n = len(strs)
    if n == 0:
        return np.zeros((0, W), dtype=np.uint64)
    k = len(strs[0])
    if all(len(s) == k for s in strs):
        # vectorised: one byte buffer -> (n, k) codes -> tree-packed words
        codes = CHAR_TO_BASE[np.frombuffer(
            "".join(strs).encode(), np.uint8)].reshape(n, k).astype(
                np.uint64)
        pad = W * 32 - k
        if pad:
            codes = np.concatenate(
                [np.zeros((n, pad), np.uint64), codes], axis=1)
        v = codes.reshape(n, W, 32)
        width = 1
        while width < 32:
            v = (v[..., 0::2] << np.uint64(2 * width)) | v[..., 1::2]
            width *= 2
        return v[..., 0]
    out = np.zeros((n, W), dtype=np.uint64)
    for i, s in enumerate(strs):
        v = 0
        for c in s.encode():
            v = (v << 2) | int(CHAR_TO_BASE[c])
        for w in range(W):
            out[i, W - 1 - w] = (v >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
    return out


def _edge_string(e: int) -> str:
    """One edge byte as 8 characters: the preceding bases 'acgt' (the
    high nibble, bit-reversed), then the following bases 'ACGT' (the low
    nibble), '.' where unset."""
    left = [(e >> (7 - b)) & 1 for b in range(4)]
    right = [(e >> b) & 1 for b in range(4)]
    return ("".join("acgt"[b] if left[b] else "." for b in range(4))
            + "".join("ACGT"[b] if right[b] else "." for b in range(4)))


_EDGE_STRS = np.array([_edge_string(e) for e in range(256)], dtype=object)


def edges_to_strings(edges: np.ndarray) -> list:
    """(N, C) uint8 -> [[8-char string per colour]], as
    edges_to_strings in mccortex_tpu/utils/text.py gives."""
    return _EDGE_STRS[edges].tolist()

"""Host-side text conversions for kmers (numpy, no device).  Copy of
kmers_to_strings in mccortex_tpu/utils/text.py; tests hold the two
equal."""

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

"""Shared constants (copy of mccortex_tpu/constants.py, which cannot be
imported without jax).

Base encoding follows the reference convention: A=0, C=1, G=2, T=3,
complement(n) = 3-n (= ~n & 3).  Code 4 marks an invalid/N base in
padded batches.

Edge bytes: bit (nuc + 4*orient) set means "traversing this kmer-key in
`orient` the next base is `nuc`"; the low nibble holds forward edges,
the high nibble reverse edges.
"""

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
BASE_INVALID = 4  # padding / N

# char (ascii) -> base code; non-ACGT -> 4
CHAR_TO_BASE = np.full(256, BASE_INVALID, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CHAR_TO_BASE[_c] = _i
for _i, _c in enumerate(b"acgt"):
    CHAR_TO_BASE[_c] = _i


def nwords(k: int) -> int:
    """Number of 64-bit words to hold a k-mer."""
    return (2 * k + 63) // 64


def check_k(k: int) -> None:
    if k < 3 or k % 2 == 0:
        raise ValueError(f"kmer size must be odd and >= 3, got {k}")

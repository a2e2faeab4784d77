"""Contig confidence table (ref src/graph/contig_confidence.c); a copy of
mccortex_tpu/graph/contig_confidence.py (numpy only).

For a genome of size G and a read-length histogram, table[dist] is the
probability that a gap of `dist` kmers between deciding junctions is
spanned by at least one read (the reference's per-step halting signal,
conf_table_lookup / calc_confid):

    lambda = covg_depth / L
    rk     = L - dist + 1
    conf   = (1 - exp(-lambda*rk)) * exp(-lambda * exp(-lambda*rk))

combined over read-length classes as 1 - prod(1 - conf_class).
"""

from __future__ import annotations

import math

import numpy as np


def calc_confid(bp_covg_depth: float, read_len: int, dist: int) -> float:
    lam = bp_covg_depth / read_len
    rk = read_len - dist + 1
    return (1.0 - math.exp(-lam * rk)) * \
        math.exp(-lam * math.exp(-lam * rk))


def conf_table(genome_size: int, read_hist: dict) -> np.ndarray:
    """read_hist: {read_length: count}.  Returns table indexed by gap
    dist (kmers), length = max read length + 1."""
    maxlen = max(read_hist) if read_hist else 0
    table = np.zeros(maxlen + 1)
    for L, n in sorted(read_hist.items()):
        covg = L * n / genome_size
        for dist in range(1, L + 1):
            c = calc_confid(covg, L, dist)
            table[dist] = 1.0 - (1.0 - table[dist]) * (1.0 - c)
    return table


def print_table(table: np.ndarray, out) -> None:
    """Reference CSV format (ref contig_confidence.c conf_table_print)."""
    out.write("gap_dist\tconfidence_0\n")
    for i in range(1, len(table)):
        out.write(f"{i}\t{table[i]:.5f}\n")

"""Assembly statistics (N50 and the like); copy of
mccortex_tpu/utils/stats.py."""

from __future__ import annotations

import numpy as np


def contig_stats(lengths, genome_size: int | None = None) -> dict:
    lengths = np.asarray(sorted(lengths, reverse=True), dtype=np.int64)
    if len(lengths) == 0:
        return {"n": 0, "total": 0, "max": 0, "min": 0, "mean": 0.0,
                "median": 0, "n50": 0, "ng50": 0}
    total = int(lengths.sum())
    cum = np.cumsum(lengths)
    n50 = int(lengths[np.searchsorted(cum, total / 2)])
    ng50 = 0
    if genome_size:
        i = np.searchsorted(cum, genome_size / 2)
        ng50 = int(lengths[i]) if i < len(lengths) else 0
    return {
        "n": len(lengths), "total": total,
        "max": int(lengths[0]), "min": int(lengths[-1]),
        "mean": float(lengths.mean()), "median": int(np.median(lengths)),
        "n50": n50, "ng50": ng50,
    }

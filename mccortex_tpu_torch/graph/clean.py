"""Error cleaning: auto threshold fit + unitig/tip removal; counterpart
of mccortex_tpu/graph/clean.py (ref src/tools/clean_graph.c).

A coverage threshold is picked from the kmer coverage histogram by
fitting error-Poisson + Gamma-mixed real coverage (a numpy/math copy of
the JAX package's fit; tests hold the two equal), then unitigs whose
median coverage is below it and short tips are dropped, on the device,
through the pointer-doubled unitig view.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import sorted as sops
from . import prune as P
from . import store as gstore
from . import unitigs as U


def covg_histogram(g: gstore.DBGraph, maxcovg: int = 1000) -> np.ndarray:
    """Histogram of per-kmer sum-across-colours coverage, clipped, binned
    on the device (only the maxcovg counts come back to the host)."""
    live = ~sops.is_sentinel(g.keys)
    s = (g.covg.to(torch.int64) & 0xFFFFFFFF).sum(dim=1).clamp(0, maxcovg - 1)
    h = torch.zeros(maxcovg, dtype=torch.int64, device=g.device)
    h.index_add_(0, s, live.to(torch.int64))
    return h.cpu().numpy().astype(np.uint64)


def pick_kmer_threshold(kmer_covg: np.ndarray):
    """Re-derivation of cleaning_pick_kmer_threshold (clean_graph.c:134).

    Fits a Poisson with Gamma-distributed mean to the low-coverage error
    component; returns (cutoff or -1, alpha, beta, fp, fn).
    """
    arrlen = len(kmer_covg)
    assert arrlen >= 10
    kmer_covg = kmer_covg.astype(np.float64)
    if kmer_covg[1] == 0 or kmer_covg[2] == 0 or kmer_covg[3] == 0:
        return -1, 0.0, 0.0, 0.0, 0.0
    r1 = kmer_covg[2] / kmer_covg[1]
    r2 = kmer_covg[3] / kmer_covg[2]
    rr = r2 / r1

    aa = np.arange(1, 201) * 0.01
    faa = (np.vectorize(math.gamma)(aa) * np.vectorize(math.gamma)(aa + 2)
           / (2 * np.vectorize(math.gamma)(aa + 1) ** 2))
    a_est = aa[np.argmin(np.abs(faa - rr))]
    b_est = math.gamma(a_est + 1.0) / (r1 * math.gamma(a_est)) - 1.0
    b_est = max(b_est, 1.0)
    c0 = kmer_covg[1] * (b_est / (1 + b_est)) ** (-a_est)

    i = np.arange(arrlen, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = (a_est * math.log(b_est) - math.lgamma(a_est)
              - np.vectorize(math.lgamma)(np.maximum(i, 1))
              + np.vectorize(math.lgamma)(np.maximum(a_est + i - 1, 1e-12))
              - (a_est + i - 1) * math.log1p(b_est))
    e_covg = np.exp(lg) * c0
    e_covg[0] = 0.0
    e_total = e_covg[1:].sum()
    d_total = kmer_covg[1:].sum()

    cutoff = -1
    # A: first coverage where errors <= 0.1% of kmers at that coverage
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = e_covg[1:] / kmer_covg[1:]
    ok = np.where(np.nan_to_num(ratio, nan=np.inf) <= 0.001)[0]
    if len(ok):
        cutoff = int(ok[0]) + 1
    if cutoff < 0:
        cutoff = _pick_cutoff_fp_lt_fn(e_covg, e_total, kmer_covg, d_total)
    if cutoff < 0:
        cutoff = _pick_cutoff_loss_vs_error(e_covg, e_total, kmer_covg)
    if cutoff < 0:
        return -1, a_est, b_est, 0.0, 0.0
    if not _is_cutoff_good(kmer_covg, cutoff, 0.2):
        return -1, a_est, b_est, 0.0, 0.0
    fp, fn = _fp_fn(e_covg, e_total, kmer_covg, d_total, cutoff)
    return cutoff, a_est, b_est, fp, fn


def _pick_cutoff_fp_lt_fn(e_covg, e_total, kmer_covg, d_total):
    e_rem, d_rem, e_sum, d_sum = e_total, float(d_total), 0.0, 0.0
    for i in range(1, len(kmer_covg)):
        e_sum += e_covg[i]
        d_sum += kmer_covg[i]
        e_rem -= e_covg[i]
        d_rem -= kmer_covg[i]
        if d_sum > 0 and d_rem > 0 and 1 - e_sum / d_sum > e_rem / d_rem:
            return i
    return -1


def _pick_cutoff_loss_vs_error(e_covg, e_total, kmer_covg):
    e_rem, e_sum, d_sum = e_total, 0.0, 0.0
    for i in range(1, len(kmer_covg)):
        e_sum += e_covg[i]
        d_sum += kmer_covg[i]
        e_rem -= e_covg[i]
        if d_sum - e_sum > e_rem:
            return i
    return -1


def _is_cutoff_good(kmer_covg, cutoff, frac_kept):
    i = np.arange(len(kmer_covg), dtype=np.float64)
    below = (kmer_covg[:cutoff] * i[:cutoff]).sum()
    above = (kmer_covg[cutoff:] * i[cutoff:]).sum()
    return below + above == 0 or above / (below + above) >= frac_kept


def _fp_fn(e_covg, e_total, kmer_covg, d_total, cutoff):
    e_sum = e_covg[1:cutoff].sum()
    d_sum = kmer_covg[1:cutoff].sum()
    e_rem = e_total - e_sum
    d_rem = d_total - d_sum
    fp = 1 - e_sum / d_sum if d_sum > 0 else 0.0
    fn = e_rem / d_rem if d_rem > 0 else 0.0
    return fp, fn


def clean_graph(g: gstore.DBGraph, covg_threshold: int = 0,
                min_keep_tip: int = 0) -> gstore.DBGraph:
    """Remove unitigs with median sum-covg < covg_threshold (if > 0) and
    tips shorter than min_keep_tip kmers (if > 0); then prune with
    edge-consistent cleanup (ref clean_graph.c:505 unitig_mark +
    prune_nodes)."""
    uv, median, is_tip, _ = U.unitig_stats(g)
    live = ~sops.is_sentinel(g.keys)
    remove = torch.zeros_like(live)
    if covg_threshold > 0:
        remove = remove | (median < covg_threshold)
    if min_keep_tip > 0:
        remove = remove | (is_tip & (uv.length < min_keep_tip))
    return P.prune_to_mask(g, live & ~remove)


def cleaning_histograms(g: gstore.DBGraph, maxcovg: int = 1000,
                        maxlen: int = 1000):
    """(kmer_covg_hist, unitig_medcovg_hist, unitig_len_hist) for the
    cleaning CSVs (ref clean_graph.c:320-333)."""
    uv, medcov, _tip, _ext = U.unitig_stats(g)
    uid = uv.uid.cpu().numpy()
    length = uv.length.cpu().numpy()
    medcov = medcov.cpu().numpy().astype(np.int64)
    n = g.n
    covg = g.covg[:n].cpu().numpy().view(np.uint32).sum(axis=1).astype(
        np.int64)
    kh = np.bincount(np.clip(covg, 0, maxcovg), minlength=maxcovg + 1)
    # one representative kmer per unitig
    _, first = np.unique(uid[:n], return_index=True)
    uh = np.bincount(np.clip(medcov[:n][first], 0, maxcovg),
                     minlength=maxcovg + 1)
    lh = np.bincount(np.clip(length[:n][first].astype(np.int64), 0,
                             maxlen), minlength=maxlen + 1)
    kh[0] = uh[0] = lh[0] = 0
    return kh, uh, lh


def write_covg_csv(path: str, kmer_hist: np.ndarray,
                   unitig_hist: np.ndarray):
    """ref cleaning_write_covg_histogram (clean_graph.c:672) format."""
    with open(path, "w") as f:
        f.write("Covg,NumKmers,NumUnitigs\n")
        end = len(kmer_hist) - 1
        while end > 2 and kmer_hist[end] == 0:
            end -= 1
        for i in range(1, end + 1):
            if kmer_hist[i] > 0:
                f.write(f"{i},{kmer_hist[i]},{unitig_hist[i]}\n")


def write_len_csv(path: str, len_hist: np.ndarray, k: int):
    """ref cleaning_write_len_histogram (clean_graph.c:694) format."""
    with open(path, "w") as f:
        f.write("UnitigKmerLength,bp,Count\n")
        end = len(len_hist) - 1
        while end > 1 and len_hist[end] == 0:
            end -= 1
        f.write(f"1,{k},{len_hist[1]}\n")
        for i in range(2, end + 1):
            if len_hist[i] > 0:
                f.write(f"{i},{k + i - 1},{len_hist[i]}\n")

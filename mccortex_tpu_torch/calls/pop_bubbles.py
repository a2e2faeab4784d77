"""Pop simple bubbles; counterpart of mccortex_tpu/calls/pop_bubbles.py.

Role of ref src/tools/pop_bubbles.c: remove one branch of two-branch
bubbles to linearise a population graph before contig assembly.  Caps:
only pop when the removed branch's mean coverage and length are within
limits; the LOWER-coverage branch is removed (ties: the
lexicographically larger allele).  Bubbles come from calls/bubbles.py,
the rows are pruned on the store's device (graph/prune.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CHAR_TO_BASE
from ..graph import prune as P
from ..graph import store as gstore
from ..ops import kmer as kops
from ..ops import sorted as sops
from . import bubbles as bub


def pop_bubbles(g: gstore.DBGraph, max_covg: int = -1, max_len: int = -1,
                max_kdiff: int = -1):
    """max_kdiff: only pop when the branch lengths differ by at most
    this many kmers (<0 = ignore; ref pop_bubbles.c:112).  Returns (the
    pruned store, bubbles popped)."""
    bl = bub.call_bubbles(g, max_allele=max(max_len, 100)
                          if max_len > 0 else 100)
    covg_np = g.covg.cpu().numpy().view(np.uint32)
    two = [bb for bb in bl if len(bb.branches) == 2]
    rows = _branch_rows(g, [bb.flank5p[-g.k:] + br for bb in two
                            for br in bb.branches], covg_np)
    remove_rows = set()
    npopped = 0
    for i, bb in enumerate(two):
        (rows_a, mc_a), (rows_b, mc_b) = rows[2 * i], rows[2 * i + 1]
        if rows_a is None or rows_b is None:
            continue
        if max_kdiff >= 0 and abs(len(bb.branches[0])
                                  - len(bb.branches[1])) > max_kdiff:
            continue
        # pick branch to remove
        if (mc_a, bb.branches[0]) <= (mc_b, bb.branches[1]):
            rows_rm, mc, ln = rows_a, mc_a, len(bb.branches[0])
        else:
            rows_rm, mc, ln = rows_b, mc_b, len(bb.branches[1])
        if max_covg >= 0 and mc > max_covg:
            continue
        if max_len >= 0 and ln > max_len:
            continue
        rows_keep = rows_b if rows_rm is rows_a else rows_a
        only = set(rows_rm) - set(rows_keep)
        if only:
            remove_rows |= only
            npopped += 1
    keep = np.ones(g.capacity, bool)
    keep[list(remove_rows)] = False
    return P.prune_to_mask(g, torch.from_numpy(keep).to(g.device)), npopped


def _branch_rows(g, seqs, covg_np):
    """(kmer rows, mean coverage) of each branch's allele path (the 5'
    flank's last kmer + the allele), the fork kmer itself dropped; (None,
    0) where no kmer is left.  Every path's kmers are looked up in one
    batch (padded with invalid bases, whose windows are not valid), as
    the JAX package looks up each path alone."""
    out = [(None, 0)] * len(seqs)
    live = [i for i, sq in enumerate(seqs) if len(sq) >= g.k]
    if not live:
        return out
    L = max(len(seqs[i]) for i in live)
    arr = np.full((len(live), L), 4, np.uint8)
    for r, i in enumerate(live):
        arr[r, :len(seqs[i])] = CHAR_TO_BASE[np.frombuffer(
            seqs[i].encode(), np.uint8)]
    kmers, valid = kops.rolling_kmers(torch.from_numpy(arr).to(g.device),
                                      g.k)
    keys, _ = kops.canonical(kmers, g.k)
    idx, found = sops.lookup(g.keys, keys.reshape(-1, g.W))
    v = (valid & found.reshape(valid.shape)).cpu().numpy()
    idx = idx.reshape(valid.shape).cpu().numpy()
    for r, i in enumerate(live):
        rows = idx[r][v[r]]
        rows = rows[1:] if len(rows) else rows  # drop the fork kmer itself
        if len(rows):
            out[i] = (rows.tolist(), int(covg_np[rows].sum(axis=1).mean()))
    return out

"""Graph integrity checks (counterpart of mccortex_tpu/utils/checks.py):
sorted, canonical, unique keys, coverage in some colour, and per-colour
edge symmetry.  Runs on the device of the keys; the messages are the
JAX package's, word for word."""

from __future__ import annotations

import torch

from ..ops import kmer as kops
from ..ops import sorted as sops


def _first(mask: torch.Tensor) -> int:
    """Index of the first True of a bool vector (0 when none)."""
    return int(torch.argmax(mask.to(torch.uint8)))


def check_graph_arrays(k: int, keys: torch.Tensor, covg: torch.Tensor,
                       edges: torch.Tensor) -> list:
    """Errors found in a graph's records: keys (N, W) int64, covg (N, C)
    int32 bit views of uint32, edges (N, C) uint8, on one device.
    Returns a list of messages, empty for a sound graph."""
    errs = []
    N = keys.shape[0]
    if N == 0:
        return errs
    dev = keys.device
    if N > 1:
        lt = kops.mw_lt(keys[:-1], keys[1:])
        if not bool(lt.all()):
            errs.append(f"keys not sorted/unique at {_first(~lt)}")
    bad = kops.mw_lt(kops.revcmp(keys, k), keys)
    if bool(bad.any()):
        errs.append(f"non-canonical key at {_first(bad)}")
    if not bool((covg != 0).any(dim=1).all()):
        errs.append("kmer with zero coverage in all colours")
    # edge symmetry: for every set edge (colour c, orient o, nuc n) on
    # node i, the neighbour key must exist and carry the symmetric bit
    edges64 = edges.to(torch.int64)
    for o in (0, 1):
        okm = kops.oriented(keys, torch.full((N,), o, dtype=torch.uint8,
                                             device=dev), k)
        first = kops.first_base(okm, k).to(torch.int64)
        for n in range(4):
            has = (edges64 & (1 << (n + 4 * o))) != 0      # (N, C)
            if not bool(has.any()):
                continue
            nxt = kops.shift_append(
                okm, torch.full((N,), n, dtype=torch.uint8, device=dev), k)
            nkey, norient = kops.canonical(nxt, k)
            idx, found = sops.lookup(keys, nkey)
            missing = has.any(dim=1) & ~found
            if bool(missing.any()):
                errs.append(
                    f"edge to absent kmer (row {_first(missing)}, "
                    f"orient {o}, nuc {n})")
                continue
            # the neighbour, entered in orientation norient, must have
            # the edge back to this kmer's first base complemented
            sym_nuc = (3 - first) & 3
            sym_bit = 1 << (sym_nuc + 4 * (1 - norient.to(torch.int64)))
            nedges = edges64[idx.long()]
            bad = has & ((nedges & sym_bit[:, None]) == 0)
            if bool(bad.any()):
                errs.append(f"asymmetric edge (row {_first(bad.any(dim=1))}"
                            f", orient {o}, nuc {n})")
    return errs

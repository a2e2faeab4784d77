"""Hashed-bucket lookup index: the batched kmer lookup of every graph
phase after build.  Counterpart of mccortex_tpu/ops/hashidx.py.

The store's ground truth stays the sorted (N, W) key array; a sidecar
table, the 128-byte-row table of kernels/lookup.py (`build_table32`: one
128-byte line of device memory a row, about half full, a full row's
further keys in the next row), answers a batch of queries with about one
row read a query.  The table holds the live keys only (the store's
sentinel tail is left out) and is memoised on the key tensor itself.

For CUDA keys the table is built on the card (kernels.lookup.
build_table32_fused) and probed by the lookup kernel (csrc/lookup.cu);
for CPU keys numpy's build_table32 builds the same bytes and the
kernel's plain version probes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.memo import Memo
from ..utils.timing import count, span
from . import sorted as sops
from .kernels import lookup as klookup

_tables = Memo()


def _build32(keys: torch.Tensor):
    """The 128-byte-row table of the live keys on the keys' device: built
    on the card for CUDA keys (the live count the one word that comes to
    the host before the build), else in numpy."""
    with span("table", keys.device):
        n = int((~sops.is_sentinel(keys)).sum())
        if keys.device.type == "cuda":
            table, b_bits, rounds = klookup.build_table32_fused(keys[:n])
            count("table.card")
            count("table.rounds", rounds)
        else:
            # live records are compacted at the front (store invariant)
            table, b_bits = klookup.build_table32(
                keys[:n].cpu().numpy().view(np.uint64))
            table = torch.from_numpy(table.view(np.int32)).to(keys.device)
    count("table.keys", n)              # a memo hit builds and counts none
    return table, b_bits


def get_index32_for(keys: torch.Tensor):
    """(128-byte-row table on the keys' device, b_bits) for the lookup
    kernel, memoised on the key tensor: every graph phase looks up in one
    store many times."""
    return _tables.get((keys,), lambda: _build32(keys),
                       tuple(keys.shape))


def lookup(keys: torch.Tensor, queries: torch.Tensor):
    """(idx int32, found bool) per query key (..., W) against the sorted
    key tensor `keys` (N, W): idx is the store row when found, else 0.
    Builds or fetches the table for `keys`."""
    table, b_bits = get_index32_for(keys)
    return klookup.lookup_fused(table, queries, b_bits, keys.shape[1])

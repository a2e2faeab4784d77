"""Segmented reduce + compaction over key-sorted record planes.

Counterpart of mccortex_tpu/ops/pallas/segreduce.py
`segreduce_compact_multi`; kernel in csrc/segreduce.cu.  Planes are
int32 rows of 2-D tensors (one row per plane), so a record array is one
(P, M) tensor and its key, sum and or planes are row slices of it.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build

TILE = 256               # records per block of the first and last pass


def _rows(x: torch.Tensor | None, M: int, device, name: str) -> torch.Tensor:
    if x is None:
        return torch.empty((0, M), dtype=torch.int32, device=device)
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != M:
        raise ValueError(f"{name} must be (P, {M}) int32 planes")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, keys on {device}")
    return x if x.stride(1) == 1 else x.contiguous()


def segreduce_plain(keys: torch.Tensor, sums: torch.Tensor,
                    ors: torch.Tensor):
    """Plain PyTorch version of the kernel (any device), through
    ops.sorted.unique_reduce."""
    M = keys.shape[1]
    live = ~sops.is_sentinel(keys.T)
    vals = torch.cat([live[None].to(torch.int32), sums]).T
    okeys, ovals, oors, n = sops.unique_reduce(keys.T, vals, ors.T, M)
    return okeys.T, ovals[:, 0], ovals[:, 1:].T, oors.T, n


def segreduce_compact_multi(keys: torch.Tensor, sums=None, ors=None):
    """Reduce each run of equal live keys to one record.

    keys (NK, M) int32 planes, most significant first, sorted in
    unsigned lexicographic order with a sentinel tail (-1 in every key
    plane); sums (NS, M) and ors (NO, M) int32 value planes (None for
    none).  Returns (okeys (NK, M), count (M,), osums (NS, M), oors
    (NO, M), n): the n unique live records compacted to the front with
    their run length, summed sums and OR-ed ors; keys -1 and values 0
    past n.  n is a 0-d tensor on the input's device.
    """
    if keys.dim() != 2 or keys.shape[0] < 1:
        raise ValueError("keys must be (NK >= 1, M) int32 planes")
    M = keys.shape[1]
    dev = keys.device
    keys = _rows(keys, M, dev, "keys")
    sums = _rows(sums, M, dev, "sums")
    ors = _rows(ors, M, dev, "ors")
    if dev.type == "cpu":
        return segreduce_plain(keys, sums, ors)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if M >= 1 << 31:
        raise ValueError(f"segreduce takes fewer than 2**31 records, got {M}")
    NK, NS, NO = keys.shape[0], sums.shape[0], ors.shape[0]
    out = torch.zeros((NK + 1 + NS + NO, M), dtype=torch.int32, device=dev)
    out[:NK] = sops.SENTINEL
    n = torch.zeros(1, dtype=torch.int32, device=dev)
    if M:
        scratch = torch.empty(-(-M // TILE), dtype=torch.int32, device=dev)
        fn = _build.function("segreduce", "mctx_segreduce", 6, 7)
        with torch.cuda.device(dev):
            rc = fn(keys.data_ptr(), sums.data_ptr() if NS else None,
                    ors.data_ptr() if NO else None, out.data_ptr(),
                    scratch.data_ptr(), n.data_ptr(), NK, NS, NO, M,
                    keys.stride(0), sums.stride(0) if NS else 0,
                    ors.stride(0) if NO else 0, _build.stream_of(keys))
        _build.check(rc, "segreduce")
    return (out[:NK], out[NK], out[NK + 1:NK + 1 + NS], out[NK + 1 + NS:],
            n[0])

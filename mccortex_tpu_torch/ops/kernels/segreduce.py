"""Segmented reduce + compaction over key-sorted record planes.

Counterpart of mccortex_tpu/ops/pallas/segreduce.py
`segreduce_compact_multi`; kernel in csrc/segreduce.cu.  Planes are
int32 rows of 2-D tensors (one row per plane), so a record array is one
(P, M) tensor and its key, sum and or planes are row slices of it.
`segreduce_planes` returns the result the same way, as one tensor, with
the count plane optional; `segreduce_compact_multi` keeps the
reference's tuple.

The kernel's tiles publish their partial results in a scratch buffer
kept per device and stream (`_Scratch`): one 16-byte descriptor a tile,
stamped with a generation that grows by one a call, so no call has to
clear them, and a side buffer for value planes past the first two.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build

TILE = 2048              # records per block of the kernel
GEN_LIMIT = 1 << 30      # status words hold the generation in 30 bits


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


def segreduce_planes_plain(keys: torch.Tensor, sums: torch.Tensor,
                           ors: torch.Tensor, count: bool = True):
    """Plain version of segreduce_planes: segreduce_plain's planes in one
    tensor."""
    okeys, cnt, osums, oors, n = segreduce_plain(keys, sums, ors)
    parts = [okeys] + ([cnt[None]] if count else []) + [osums, oors]
    return torch.cat(parts), n


class _Scratch:
    """The look-back's scratch on one device and stream: the tiles'
    descriptors (4 int32 each; zeroed once, when allocated) and the side
    buffer of further values, grown on demand, and the generation of the
    last call."""

    def __init__(self, device):
        self.device = device
        self.desc = torch.zeros((0, 4), dtype=torch.int32, device=device)
        self.extra = torch.empty(0, dtype=torch.int32, device=device)
        self.gen = 0

    def take(self, tiles: int, extra_words: int):
        if self.desc.shape[0] < tiles:
            self.desc = torch.zeros((max(tiles, 2 * self.desc.shape[0]), 4),
                                    dtype=torch.int32, device=self.device)
            self.gen = 0
        if self.extra.numel() < extra_words:
            self.extra = torch.empty(
                max(extra_words, 2 * self.extra.numel()),
                dtype=torch.int32, device=self.device)
        self.gen += 1
        if self.gen >= GEN_LIMIT:        # every 2**30 calls: start over
            self.desc.zero_()
            self.gen = 1
        return self.desc, self.extra, self.gen


_scratch: dict = {}


def _scratch_for(device, stream: int) -> _Scratch:
    key = (device.index, stream)
    s = _scratch.get(key)
    if s is None:
        s = _scratch[key] = _Scratch(device)
    return s


def segreduce_planes(keys: torch.Tensor, sums=None, ors=None,
                     count: bool = True):
    """Reduce each run of equal live keys to one record.

    keys (NK, M) int32 planes, most significant first, sorted in
    unsigned lexicographic order with a sentinel tail (-1 in every key
    plane); sums (NS, M) and ors (NO, M) int32 value planes (None for
    none).  Returns (planes, n): planes is one (NK + count + NS + NO, M)
    int32 tensor whose rows are the keys, the run length (only with
    count=True), the summed sums (modulo 2**32) and the OR-ed ors of the
    n unique live records, compacted to the front, with keys -1 and
    values 0 past n; n is a 0-d tensor on the input's device.  A CUDA
    call launches the kernel and a fill of the slots past n.
    """
    if keys.dim() != 2 or keys.shape[0] < 1:
        raise ValueError("keys must be (NK >= 1, M) int32 planes")
    M = keys.shape[1]
    dev = keys.device
    keys = _rows(keys, M, dev, "keys")
    sums = _rows(sums, M, dev, "sums")
    ors = _rows(ors, M, dev, "ors")
    if dev.type == "cpu":
        return segreduce_planes_plain(keys, sums, ors, count)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if M >= 1 << 31:
        raise ValueError(f"segreduce takes fewer than 2**31 records, got {M}")
    NK, NS, NO = keys.shape[0], sums.shape[0], ors.shape[0]
    nv = int(count) + NS + NO
    out = torch.empty((NK + nv, M), dtype=torch.int32, device=dev)
    if not M:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    stream = _build.stream_of(keys)
    tiles = -(-M // TILE)
    desc, extra, gen = _scratch_for(dev, stream).take(
        tiles, tiles * 2 * max(nv - 2, 0))
    fn = _build.function("segreduce", "mctx_segreduce", 7, 9)
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), sums.data_ptr() if NS else None,
                ors.data_ptr() if NO else None, out.data_ptr(),
                desc.data_ptr(), extra.data_ptr(), n.data_ptr(), NK, NS,
                NO, int(count), M, keys.stride(0),
                sums.stride(0) if NS else 0, ors.stride(0) if NO else 0, gen,
                stream)
    _build.check(rc, "segreduce")
    return out, n[0]


def segreduce_compact_multi(keys: torch.Tensor, sums=None, ors=None):
    """Reduce each run of equal live keys to one record: the reference's
    tuple (okeys (NK, M), count (M,), osums (NS, M), oors (NO, M), n),
    as row views of segreduce_planes' one tensor."""
    NK = keys.shape[0] if keys.dim() == 2 else 0
    NS = 0 if sums is None else sums.shape[0]
    planes, n = segreduce_planes(keys, sums, ors)
    return (planes[:NK], planes[NK], planes[NK + 1:NK + 1 + NS],
            planes[NK + 1 + NS:], n)

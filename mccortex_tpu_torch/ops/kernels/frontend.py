"""Build front-end: read batch -> canonical key planes + edge bytes.

Counterpart of mccortex_tpu/ops/pallas/frontend.py `records_fused`
(with_valid=False); kernel in csrc/frontend.cu.  `records_fused` gives
the (B, L) planes of the reference; `records_epoch` gives the first
Lv = L - k + 1 windows of every row as the (NL + 1, B * Lv) planes that
a build epoch sorts, straight from the kernel.
"""

from __future__ import annotations

import torch

from ...constants import nwords
from ..kmer import to_planes
from . import _build

MAX_L = 65536            # the packed read rows must fit shared memory


def records_plain(bases: torch.Tensor, k: int) -> tuple:
    """Plain PyTorch version of the kernel: the same planes, from
    graph.build.reads_to_records (any device)."""
    from ...graph.build import reads_to_records
    B, L = bases.shape
    keys, ebyte, _valid = reads_to_records(bases, k)
    W = nwords(k)
    planes = to_planes(keys.reshape(B * L, W)).reshape(2 * W, B, L)
    return tuple(planes) + (ebyte.to(torch.int32),)


def epoch_windows(L: int, k: int) -> int:
    """Windows of a row that an epoch keeps: only the first L - k + 1
    can hold a kmer, and a row shorter than k keeps one (invalid)."""
    return max(L - k + 1, 1)


def records_epoch_plain(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of records_epoch: records_plain's planes cut to the
    epoch's windows."""
    B, L = bases.shape
    lv = epoch_windows(L, k)
    if L < lv:                       # empty rows: one invalid window
        bases = torch.full((B, lv), 4, dtype=torch.uint8,
                           device=bases.device)
    planes = torch.stack(records_plain(bases, k))
    return planes[:, :, :lv].reshape(planes.shape[0], B * lv)


def _check(bases: torch.Tensor, k: int) -> None:
    if not 3 <= k <= 63:
        raise ValueError(f"front-end kernel takes 3 <= k <= 63, got {k}")
    if bases.dtype != torch.uint8 or bases.dim() != 2:
        raise ValueError("bases must be a (B, L) uint8 tensor")
    if bases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bases.device}")
    if bases.shape[1] > MAX_L:
        raise ValueError(f"read rows longer than {MAX_L} bases: chunk them")


def _launch(bases: torch.Tensor, k: int, lv: int) -> torch.Tensor:
    """The kernel: the first lv windows of every row, (NL + 1, B * lv)."""
    B, L = bases.shape
    bases = bases.contiguous()
    out = torch.empty((2 * nwords(k) + 1, B * lv), dtype=torch.int32,
                      device=bases.device)
    if B * lv:
        fn = _build.function("frontend", "mctx_frontend", 2, 4)
        with torch.cuda.device(bases.device):
            rc = fn(bases.data_ptr(), out.data_ptr(), B, L, lv, k,
                    _build.stream_of(bases))
        _build.check(rc, "frontend")
    return out


def records_fused(bases: torch.Tensor, k: int) -> tuple:
    """bases (B, L) uint8 codes (4 = N/pad), k <= 63 -> (*key_planes,
    ebyte): (B, L) int32 planes.  Key planes are the most-significant-
    first 32-bit limbs of the canonical key's W words (2 for k <= 32,
    4 for k <= 63); windows that do not fit or hold an N are -1 in every key
    plane and 0 in the edge plane."""
    _check(bases, k)
    if bases.device.type == "cpu":
        return records_plain(bases, k)
    B, L = bases.shape
    if B * L == 0:
        return tuple(torch.empty((2 * nwords(k) + 1, B, L), dtype=torch.int32,
                                 device=bases.device))
    return tuple(_launch(bases, k, L).view(-1, B, L))


def records_epoch(bases: torch.Tensor, k: int) -> torch.Tensor:
    """The planes of records_fused cut to each row's first
    Lv = epoch_windows(L, k) windows, as one (NL + 1, B * Lv) int32
    tensor (key planes, then the edge plane; row-major windows), which
    the kernel writes directly."""
    _check(bases, k)
    if bases.device.type == "cpu":
        return records_epoch_plain(bases, k)
    B, L = bases.shape
    lv = epoch_windows(L, k)
    if L < lv:                       # empty rows: one invalid window
        bases = torch.full((B, lv), 4, dtype=torch.uint8,
                           device=bases.device)
    return _launch(bases, k, lv)

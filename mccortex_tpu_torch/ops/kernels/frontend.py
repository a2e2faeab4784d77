"""Build front-end: read batch -> canonical key planes + edge bytes.

Counterpart of mccortex_tpu/ops/pallas/frontend.py `records_fused`
(with_valid=False); kernel in csrc/frontend.cu.
"""

from __future__ import annotations

import torch

from ...constants import nwords
from ..kmer import to_planes
from . import _build

MAX_L = 49152            # the staged read rows must fit shared memory


def records_plain(bases: torch.Tensor, k: int) -> tuple:
    """Plain PyTorch version of the kernel: the same planes, from
    graph.build.reads_to_records (any device)."""
    from ...graph.build import reads_to_records
    B, L = bases.shape
    keys, ebyte, _valid = reads_to_records(bases, k)
    planes = to_planes(keys.reshape(B * L, -1)).reshape(-1, B, L)
    return tuple(planes) + (ebyte.to(torch.int32),)


def records_fused(bases: torch.Tensor, k: int) -> tuple:
    """bases (B, L) uint8 codes (4 = N/pad), k <= 63 -> (*key_planes,
    ebyte): (B, L) int32 planes.  Key planes are the most-significant-
    first 32-bit limbs of the canonical key (2 for k <= 31, 4 for
    k <= 63); windows that do not fit or hold an N are -1 in every key
    plane and 0 in the edge plane."""
    if not 3 <= k <= 63:
        raise ValueError(f"front-end kernel takes 3 <= k <= 63, got {k}")
    if bases.dtype != torch.uint8 or bases.dim() != 2:
        raise ValueError("bases must be a (B, L) uint8 tensor")
    if bases.device.type == "cpu":
        return records_plain(bases, k)
    if bases.device.type != "cuda":
        raise ValueError(f"unsupported device {bases.device}")
    B, L = bases.shape
    if L > MAX_L:
        raise ValueError(f"read rows longer than {MAX_L} bases: chunk them")
    bases = bases.contiguous()
    nl = 2 * nwords(k)
    out = torch.empty((nl + 1, B, L), dtype=torch.int32, device=bases.device)
    if B * L:
        fn = _build.function("frontend", "mctx_frontend", 2, 3)
        with torch.cuda.device(bases.device):
            rc = fn(bases.data_ptr(), out.data_ptr(), B, L, k,
                    _build.stream_of(bases))
        _build.check(rc, "frontend")
    return tuple(out)

"""Merge two sorted record-plane sets in one data pass (merge path).

Counterpart of mccortex_tpu/ops/pallas/mergepath.py `merge_path_planes`;
kernel in csrc/mergepath.cu.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build

TILE = 1024              # merged outputs per block
MAX_KEYS = 8             # key planes the kernel stages in shared memory


def merge_plain(a: torch.Tensor, b: torch.Tensor,
                num_keys: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): concatenate and
    stable-sort, which is exactly the stable merge."""
    both = torch.cat([a, b], dim=1)
    return both[:, sops.argsort_planes(both[:num_keys])]


def merge_path_planes(a: torch.Tensor, b: torch.Tensor,
                      num_keys: int) -> torch.Tensor:
    """Merge a (np, Ma) and b (np, Mb) int32 record planes, each sorted
    in unsigned lexicographic order on its first num_keys planes, into
    (np, Ma + Mb).  Stable: on equal keys a's records come first."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError("a and b must be (np, M) planes of one np")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("planes must be int32")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    np_ = a.shape[0]
    if not 1 <= num_keys <= min(np_, MAX_KEYS):
        raise ValueError(f"num_keys must be in 1..{min(np_, MAX_KEYS)}")
    if a.device.type == "cpu":
        return merge_plain(a, b, num_keys)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    Ma, Mb = a.shape[1], b.shape[1]
    if Ma + Mb >= 1 << 31:
        raise ValueError("merge path takes fewer than 2**31 records")
    out = torch.empty((np_, Ma + Mb), dtype=torch.int32, device=a.device)
    if Ma + Mb:
        split = torch.empty(-(-(Ma + Mb) // TILE) + 1, dtype=torch.int32,
                            device=a.device)
        fn = _build.function("mergepath", "mctx_mergepath", 4, 6)
        with torch.cuda.device(a.device):
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    split.data_ptr(), Ma, Mb, num_keys, np_, a.stride(0),
                    b.stride(0), _build.stream_of(a))
        _build.check(rc, "mergepath")
    return out

"""Merge path: merge two sorted record-plane sets in one data pass, one
level of a merge tree, and the sort built from them.

Counterpart of mccortex_tpu/ops/pallas/mergepath.py `merge_path_planes`,
`_merge_level` and `sort_planes_mp`; kernels in csrc/mergepath.cu (and
csrc/bitonic.cu for the tile sort under sort_planes_mp).

Tie order: every function here is stable.  `merge_path_planes` and
`merge_level` keep the first input's (the first run's) records first on
equal keys; `sort_planes_mp` (a stable tile sort, then stable levels)
equals `planes[:, sops.argsort_planes(planes[:num_keys])]` on every
plane.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build, bitonic

TILE = 1024              # merged outputs per block
MAX_KEYS = 9             # key planes the kernel stages in shared memory


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


def _count_before(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  q: torch.Tensor, or_equal: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """Per query: the first position in its own window [lo, hi) of the
    (nk, M) key planes whose record does not sort before the record at q
    (where or_equal: before or equal to it).  A batched binary search
    over windows that are each sorted."""
    last = keys.shape[1] - 1
    qk = keys[:, q]
    for _ in range(steps):
        go = lo < hi
        mid = (lo + hi) >> 1
        mk = keys[:, mid.clamp(max=last)]
        ahead = bitonic.lex_lt(mk, qk) | (or_equal & ~bitonic.lex_lt(qk, mk))
        lo = torch.where(go & ahead, mid + 1, lo)
        hi = torch.where(go & ~ahead, mid, hi)
    return lo


def merge_level_plain(planes: torch.Tensor, num_keys: int,
                      R: int) -> torch.Tensor:
    """Plain PyTorch version of the level kernel (any device): every
    record's place in its pair's merged run is its place in its own run
    plus the number of records of the partner run that go before it
    (strictly smaller for the first run, smaller or equal for the
    second), found by binary search in the partner run."""
    M = planes.shape[1]
    if M == 0:
        return planes.clone()
    i = torch.arange(M, device=planes.device)
    base = i // (2 * R) * (2 * R)
    mid = (base + R).clamp(max=M)
    end = (base + 2 * R).clamp(max=M)
    first = i < mid
    pos = _count_before(planes[:num_keys], torch.where(first, mid, base),
                        torch.where(first, end, mid), i, ~first,
                        max(R, 2).bit_length() + 1)
    out = torch.empty_like(planes)
    out[:, i - mid + pos] = planes
    return out


def merge_level(planes: torch.Tensor, num_keys: int, R: int) -> torch.Tensor:
    """One level of a merge tree: (np, M) int32 planes whose runs of R
    records ([0, R), [R, 2R), ...; the last may be shorter) are each
    sorted on the first num_keys planes -> runs of 2R, each the stable
    merge of two neighbouring runs.  Any M: a last run without a partner
    is copied."""
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError("planes must be a (np, M) int32 tensor")
    np_, M = planes.shape
    if not 1 <= num_keys <= min(np_, MAX_KEYS):
        raise ValueError(f"num_keys must be in 1..{min(np_, MAX_KEYS)}")
    if R < 1:
        raise ValueError(f"run length must be positive, got {R}")
    if M >= 1 << 31:
        raise ValueError("merge level takes fewer than 2**31 records")
    if planes.device.type == "cpu":
        return merge_level_plain(planes, num_keys, R)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    planes = planes if planes.stride(1) == 1 else planes.contiguous()
    out = torch.empty((np_, M), dtype=torch.int32, device=planes.device)
    if M:
        R = min(R, M)    # one pair then; keeps 2R inside an int
        npairs = -(-M // (2 * R))
        split = torch.empty(npairs * (-(-2 * R // TILE) + 1),
                            dtype=torch.int32, device=planes.device)
        fn = _build.function("mergepath", "mctx_mergelevel", 3, 6)
        with torch.cuda.device(planes.device):
            rc = fn(planes.data_ptr(), out.data_ptr(), split.data_ptr(), M,
                    R, num_keys, np_, planes.stride(0), out.stride(0),
                    _build.stream_of(planes))
        _build.check(rc, "mergelevel")
    return out


def _merge_tree(sp, num_keys, R, level_fn):
    M = sp.shape[1]
    while R < M:
        sp = level_fn(sp, num_keys, R)
        R *= 2
    return sp


def sort_planes_mp_plain(planes: torch.Tensor, num_keys: int,
                         tile: int = bitonic.TILE) -> torch.Tensor:
    """Plain PyTorch version of sort_planes_mp (any device): the plain
    tile sort, then the plain levels."""
    return _merge_tree(bitonic.block_sort_plain(planes, num_keys, True, tile),
                       num_keys, tile, merge_level_plain)


def sort_planes_mp(planes: torch.Tensor, num_keys: int,
                   tile: int | None = None) -> torch.Tensor:
    """Stable sort of (np, M) int32 planes on the first num_keys planes
    (unsigned, most significant first): the tile sort of
    kernels/bitonic.py with every tile ascending, then merge levels of
    run length tile, 2 tile, ... until one run is left.  Any M."""
    sp = bitonic.block_sort(planes, num_keys, all_asc=True, tile=tile)
    return _merge_tree(sp, num_keys, tile or bitonic.TILE, merge_level)

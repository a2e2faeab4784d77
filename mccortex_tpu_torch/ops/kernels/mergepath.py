"""Merge path: merge two sorted record-plane sets in one data pass, the
levels of a merge tree, and the sort built from them.

Counterpart of mccortex_tpu/ops/pallas/mergepath.py `merge_path_planes`,
`_merge_level` and `sort_planes_mp`; kernels in csrc/mergepath.cu (and
csrc/bitonic.cu for the tile sort under sort_planes_mp).

Tie order: every function here is stable.  `merge_path_planes`,
`merge_level` and `merge_levels` keep the first input's (the first
run's) records first on equal keys; `sort_planes_mp` (a stable tile sort, then stable levels)
equals `planes[:, sops.argsort_planes(planes[:num_keys])]` on every
plane.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build, bitonic

TILE = 1024              # merged outputs per block
MAX_KEYS = 9             # key planes the kernel stages in shared memory
SHARED_MAX = 232448      # bytes of shared memory an H100 block may ask for
# Most records of a fused group of levels: the kernel takes up to 16,384
# (1024 threads x 16).  Measured at an epoch's shape, levels fused on the
# few SMs that 8,192-record groups occupy cost about as much device time
# as the same levels one launch each, and 16,384-record groups more.
FUSE_RECORDS = 8192


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


def _fused_bytes(np_: int, G: int) -> int:
    """Shared memory of a block that stages a group of G records: every
    plane at a stride of whole 16 bytes, and a 16-bit source place each."""
    return np_ * ((G + 3) & ~3) * 4 + ((2 * G + 15) & ~15)


def fused_levels(np_: int, R: int, levels: int) -> int:
    """How many of the next `levels` levels over runs of R one launch of
    the fused kernel takes: the largest L whose group of R << L records
    fits, every plane, in one block's shared memory and in FUSE_RECORDS.
    0 when not even one pair of runs fits."""
    L = 0
    while L < levels and R << (L + 1) <= FUSE_RECORDS and \
            _fused_bytes(np_, R << (L + 1)) <= SHARED_MAX:
        L += 1
    return L


def merge_levels_plain(planes: torch.Tensor, num_keys: int, R: int,
                       levels: int) -> torch.Tensor:
    """Plain PyTorch version of merge_levels (any device): the plain level,
    level after level."""
    for _ in range(levels):
        planes = merge_level_plain(planes, num_keys, R)
        R *= 2
    return planes


def merge_levels(planes: torch.Tensor, num_keys: int, R: int,
                 levels: int) -> torch.Tensor:
    """`levels` levels of a merge tree: (np, M) int32 planes whose runs of
    R records ([0, R), [R, 2R), ...; the last may be shorter) are each
    sorted on the first num_keys planes -> runs of R << levels, each the
    stable merge of its runs.  Any M: a last run without a partner is
    copied.  On the card, the levels whose groups fit in a block's shared
    memory go several to a kernel launch (fused_levels), the others one
    launch each."""
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError("planes must be a (np, M) int32 tensor")
    np_, M = planes.shape
    if not 1 <= num_keys <= min(np_, MAX_KEYS):
        raise ValueError(f"num_keys must be in 1..{min(np_, MAX_KEYS)}")
    if R < 1:
        raise ValueError(f"run length must be positive, got {R}")
    if levels < 1:
        raise ValueError(f"levels must be positive, got {levels}")
    if M >= 1 << 31:
        raise ValueError("merge level takes fewer than 2**31 records")
    if planes.device.type == "cpu":
        return merge_levels_plain(planes, num_keys, R, levels)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if M == 0:
        return planes.clone()
    R = min(R, M)        # one run then; keeps 2R inside an int
    fn = _build.function("mergepath", "mctx_mergelevel", 2, 8)
    while True:
        planes = planes if planes.stride(1) == 1 else planes.contiguous()
        out = torch.empty((np_, M), dtype=torch.int32, device=planes.device)
        L = fused_levels(np_, R, levels)
        with torch.cuda.device(planes.device):
            rc = fn(planes.data_ptr(), out.data_ptr(), M, R, num_keys, np_,
                    planes.stride(0), out.stride(0), max(L, 1), int(L > 0),
                    _build.stream_of(planes))
        _build.check(rc, "mergelevel")
        planes = out
        levels -= max(L, 1)
        R <<= max(L, 1)
        if levels == 0 or R >= M:    # one run is left: further levels copy
            return planes


def merge_level(planes: torch.Tensor, num_keys: int, R: int) -> torch.Tensor:
    """One level of a merge tree (merge_levels with levels = 1): runs of
    R -> runs of 2R.  One kernel launch on the card."""
    return merge_levels(planes, num_keys, R, 1)


def _tree_levels(M: int, R: int) -> int:
    """Levels that turn runs of R into one run of M records."""
    return (max(1, -(-M // R)) - 1).bit_length()


def sort_planes_mp_plain(planes: torch.Tensor, num_keys: int,
                         tile: int = bitonic.TILE) -> torch.Tensor:
    """Plain PyTorch version of sort_planes_mp (any device): the plain
    tile sort, then the plain levels."""
    sp = bitonic.block_sort_plain(planes, num_keys, True, tile)
    levels = _tree_levels(planes.shape[1], tile)
    return merge_levels_plain(sp, num_keys, tile, levels)


def sort_planes_mp(planes: torch.Tensor, num_keys: int,
                   tile: int | None = None) -> torch.Tensor:
    """Stable sort of (np, M) int32 planes on the first num_keys planes
    (unsigned, most significant first): the tile sort of
    kernels/bitonic.py with every tile ascending, then merge levels of
    run length tile, 2 tile, ... until one run is left (the first ones
    fused, see merge_levels).  Any M."""
    sp = bitonic.block_sort(planes, num_keys, all_asc=True, tile=tile)
    levels = _tree_levels(planes.shape[1], tile or bitonic.TILE)
    if levels == 0:
        return sp
    return merge_levels(sp, num_keys, tile or bitonic.TILE, levels)

"""Bitonic sort and merge over int32 record planes.

Counterpart of mccortex_tpu/ops/pallas/bitonic.py (`sort_planes`,
`merge_planes`, and the block sort and tail kernels under them); kernels
in csrc/bitonic.cu.  A record array is one (np, M) int32 tensor; its
first num_keys planes are the key, most significant first, compared as
unsigned 32-bit words (the sentinel -1 sorts last).

Tie order.  `block_sort` breaks ties on the source position, so an
ascending tile equals a stable sort of that tile on every plane and a
descending tile is its exact reverse.  `tail`, `butterfly`, and so
`sort_planes` and `merge_planes`, are not stable: their key planes
equal a stable sort's element for element, and within each run of equal
keys the records are the same multiset.  Every function gives the same
output from run to run (no atomics), and kernel and plain version agree
on every plane.

The plain versions follow the kernels' tiling (sort each tile, then the
same compare-exchange network), and take a `tile` argument so that
tests can use small tiles; the kernels' tile is fixed at TILE.
"""

from __future__ import annotations

import torch

from .. import sorted as sops
from . import _build

TILE = 2048              # records per block of the block sort and the tail
MAX_KEYS = 9             # key planes the kernels stage in shared memory
_FLIP = -0x80000000      # int32 sign bit: x ^ _FLIP orders as unsigned


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b in unsigned lexicographic order over the leading dimension
    (key planes, most significant first) of two int32 tensors."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    for p in range(a.shape[0] - 1, -1, -1):
        x, y = a[p] ^ _FLIP, b[p] ^ _FLIP
        lt = (x < y) | ((x == y) & lt)
    return lt


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _check(planes: torch.Tensor, num_keys: int, tile: int | None) -> int:
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError("planes must be a (np, M) int32 tensor")
    if not 1 <= num_keys <= min(planes.shape[0], MAX_KEYS):
        raise ValueError(
            f"num_keys must be in 1..{min(planes.shape[0], MAX_KEYS)}")
    if planes.shape[1] >= 1 << 31:
        raise ValueError("takes fewer than 2**31 records")
    tile = tile or TILE
    if planes.device.type == "cuda":
        if tile != TILE:
            raise ValueError(f"the kernels' tile is {TILE}, not {tile}")
    elif planes.device.type != "cpu":
        raise ValueError(f"unsupported device {planes.device}")
    if not _is_pow2(tile):
        raise ValueError(f"tile must be a power of two, got {tile}")
    return tile


def _rows(planes: torch.Tensor) -> torch.Tensor:
    return planes if planes.stride(1) == 1 else planes.contiguous()


def pad_planes(planes: torch.Tensor, num_keys: int,
               length: int) -> torch.Tensor:
    """planes padded to `length` records: -1 in the key planes (sorts
    last), 0 in the others."""
    np_, M = planes.shape
    if length == M:
        return planes
    out = torch.zeros((np_, length), dtype=planes.dtype, device=planes.device)
    out[:num_keys, M:] = sops.SENTINEL
    out[:, :M] = planes
    return out


def padded_length(M: int, tile: int | None = None) -> int:
    """The length sort_planes takes for M records: the next power of two,
    at least one tile."""
    return max(tile or TILE, 1 << max(M - 1, 0).bit_length())


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------

def block_sort_plain(planes: torch.Tensor, num_keys: int, all_asc: bool,
                     tile: int) -> torch.Tensor:
    """Every tile sorted stably on the keys; odd tiles reversed unless
    all_asc."""
    M = planes.shape[1]
    tid = (torch.arange(M, device=planes.device) // tile).to(torch.int32)
    perm = sops.argsort_planes(torch.cat([tid[None], planes[:num_keys]]))
    if not all_asc and M > tile:
        rows = perm.view(-1, tile)
        rows[1::2] = rows[1::2].flip(1)
    return planes[:, perm]


def cmpx_plain(planes: torch.Tensor, num_keys: int, j: int, k: int,
               final_asc: bool) -> torch.Tensor:
    """One compare-exchange substep at distance j of merge stage k: the
    records at i and i + j (bit j of i clear) swap when their keys are
    strictly out of order for the direction of i's k-group (ascending
    iff (i & k) == 0, or everywhere when final_asc)."""
    np_, M = planes.shape
    G = M // (2 * j)
    v = planes.reshape(np_, G, 2, j)
    a, b = v[:, :, 0], v[:, :, 1]
    if final_asc:
        swap = lex_lt(b[:num_keys], a[:num_keys])
    else:
        asc = ((torch.arange(G, device=planes.device) * (2 * j)) & k) == 0
        swap = torch.where(asc[:, None], lex_lt(b[:num_keys], a[:num_keys]),
                           lex_lt(a[:num_keys], b[:num_keys]))
    return torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                       dim=2).reshape(np_, M)


def tail_plain(planes: torch.Tensor, num_keys: int, k: int, final_asc: bool,
               tile: int) -> torch.Tensor:
    j = tile // 2
    while j >= 1:
        planes = cmpx_plain(planes, num_keys, j, k, final_asc)
        j //= 2
    return planes


# ---------------------------------------------------------------------------
# wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def block_sort(planes: torch.Tensor, num_keys: int, all_asc: bool = False,
               tile: int | None = None) -> torch.Tensor:
    """Sort every tile of `tile` records on the first num_keys planes
    (stable; a descending tile is the reverse).  Tile t leaves ascending
    when all_asc or t is even, else descending.  M must be a multiple of
    the tile unless every tile leaves ascending (all_asc, or M <= tile)."""
    tile = _check(planes, num_keys, tile)
    np_, M = planes.shape
    if not all_asc and M > tile and M % tile:
        raise ValueError(f"M = {M} is not a multiple of the tile {tile}")
    if planes.device.type == "cpu":
        return block_sort_plain(planes, num_keys, all_asc, tile)
    planes = _rows(planes)
    out = torch.empty((np_, M), dtype=torch.int32, device=planes.device)
    if M:
        fn = _build.function("bitonic", "mctx_bitonic_blocksort", 2, 6)
        with torch.cuda.device(planes.device):
            rc = fn(planes.data_ptr(), out.data_ptr(), M, num_keys, np_,
                    planes.stride(0), out.stride(0), int(all_asc),
                    _build.stream_of(planes))
        _build.check(rc, "bitonic_blocksort")
    return out


def tail(planes: torch.Tensor, num_keys: int, k: int, final_asc: bool,
         tile: int | None = None) -> torch.Tensor:
    """All substeps of distance tile/2..1 of merge stage k (a power of
    two >= tile) in one pass; M a multiple of the tile."""
    tile = _check(planes, num_keys, tile)
    np_, M = planes.shape
    if M % tile or not _is_pow2(k) or k < tile:
        raise ValueError(f"M = {M} and k = {k} must be multiples of the "
                         f"tile {tile}, k a power of two")
    if planes.device.type == "cpu":
        return tail_plain(planes, num_keys, k, final_asc, tile)
    planes = _rows(planes)
    out = torch.empty((np_, M), dtype=torch.int32, device=planes.device)
    if M:
        fn = _build.function("bitonic", "mctx_bitonic_tail", 2, 7)
        with torch.cuda.device(planes.device):
            rc = fn(planes.data_ptr(), out.data_ptr(), M, num_keys, np_,
                    planes.stride(0), out.stride(0), k.bit_length() - 1,
                    int(final_asc), _build.stream_of(planes))
        _build.check(rc, "bitonic_tail")
    return out


def butterfly(planes: torch.Tensor, num_keys: int, j: int, k: int,
              final_asc: bool) -> torch.Tensor:
    """One compare-exchange substep at distance j of merge stage k (see
    cmpx_plain); M a multiple of 2j.  A CUDA tensor with unit column
    stride is updated in place and returned."""
    _check(planes, num_keys, None)
    np_, M = planes.shape
    if not _is_pow2(j) or not _is_pow2(k) or M % (2 * j):
        raise ValueError(f"j = {j} and k = {k} must be powers of two and "
                         f"M = {M} a multiple of 2j")
    if planes.device.type == "cpu":
        return cmpx_plain(planes, num_keys, j, k, final_asc)
    planes = _rows(planes)
    if M:
        fn = _build.function("bitonic", "mctx_bitonic_butterfly", 1, 7)
        with torch.cuda.device(planes.device):
            rc = fn(planes.data_ptr(), M, num_keys, np_, planes.stride(0),
                    j.bit_length() - 1, k.bit_length() - 1, int(final_asc),
                    _build.stream_of(planes))
        _build.check(rc, "bitonic_butterfly")
    return planes


def _sort_network(planes, num_keys, tile, block_sort_fn, butterfly_fn,
                  tail_fn):
    M = planes.shape[1]
    sp = block_sort_fn(planes, num_keys, False, tile)
    k = 2 * tile
    while k <= M:
        j = k // 2
        while j >= tile:
            sp = butterfly_fn(sp, num_keys, j, k, k >= M)
            j //= 2
        sp = tail_fn(sp, num_keys, k, k >= M, tile)
        k *= 2
    return sp


def _merge_network(a, b, num_keys, tile, butterfly_fn, tail_fn):
    M = 2 * a.shape[1]
    sp = torch.cat([a, b.flip(1)], dim=1)
    j = M // 2
    while j >= tile:
        sp = butterfly_fn(sp, num_keys, j, M, True)
        j //= 2
    return tail_fn(sp, num_keys, M, True, tile)


def sort_planes_plain(planes: torch.Tensor, num_keys: int,
                      tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of sort_planes (any device): the same
    network from the plain tile sort, compare-exchange and tail."""
    return _sort_network(planes, num_keys, tile, block_sort_plain, cmpx_plain,
                         tail_plain)


def merge_planes_plain(a: torch.Tensor, b: torch.Tensor, num_keys: int,
                       tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of merge_planes (any device)."""
    return _merge_network(a, b, num_keys, tile, cmpx_plain, tail_plain)


def sort_planes(planes: torch.Tensor, num_keys: int,
                tile: int | None = None) -> torch.Tensor:
    """Sort (np, M) planes on the first num_keys planes with the bitonic
    network: a block sort, then per merge stage k = 2*tile .. M the
    cross-tile butterflies and one tail.  M must be a power of two and at
    least one tile, or at most one tile: pad with pad_planes to
    padded_length(M); the sorted live records are the prefix as long as
    no live record with an all-ones key carries a non-zero payload.  Not
    stable (see the module's note on tie order)."""
    tile = _check(planes, num_keys, tile)
    M = planes.shape[1]
    if M > tile and not _is_pow2(M):
        raise ValueError(f"M = {M} must be a power of two (pad_planes)")
    if planes.device.type == "cpu":
        return sort_planes_plain(planes, num_keys, tile)
    return _sort_network(planes, num_keys, tile, block_sort, butterfly, tail)


def merge_planes(a: torch.Tensor, b: torch.Tensor, num_keys: int,
                 tile: int | None = None) -> torch.Tensor:
    """Merge two sorted (np, Mh) plane sets of one length Mh, a power of
    two and at least one tile (pad_planes), into (np, 2 Mh): one bitonic
    merge stage over a followed by b reversed.  Not stable."""
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must be (np, Mh) planes of one shape and "
                         "device")
    tile = _check(a, num_keys, tile)
    _check(b, num_keys, tile)
    Mh = a.shape[1]
    if not _is_pow2(Mh) or Mh < tile:
        raise ValueError(f"Mh = {Mh} must be a power of two >= the tile "
                         f"{tile} (pad_planes)")
    if a.device.type == "cpu":
        return merge_planes_plain(a, b, num_keys, tile)
    return _merge_network(a, b, num_keys, tile, butterfly, tail)

"""Hashed-bucket lookup index: the batched kmer lookup of every graph
phase after build.  Counterpart of mccortex_tpu/ops/hashidx.py.

The store's ground truth stays the sorted (N, W) key array; a sidecar
table answers a batch of queries with one bucket-row read per query:

  planar table (build_table): (B, P*EPR) uint32, P = 2W+1 planes laid
      out plane-major [w0_hi | w0_lo | ... | row_idx], EPR slots each;
  128-byte-row table (kernels.lookup.build_table32): one 128-byte line
      of device memory per row, S = 32 // P slots per plane, about half
      full; a full row's further keys sit in the next row.  The lookup
      kernel's table.

(kernels.lookup.build_table128, the JAX package's 512-byte row of 128
lanes per bucket, is kept as a copy of the reference's layout; the
kernel reads it too, but no lookup here builds it.)

bucket(key) = kmer_hash(key) >> (64 - b_bits).  Empty slots hold
0xFFFFFFFF, which no valid canonical kmer has in its top word (k odd).
The planar table is built on the host in numpy (as the JAX package
does) and copied to the keys' device; the 128-byte-row table is built on
the card for CUDA keys (kernels.lookup.build_table32_fused, the same
bytes) and in numpy for CPU keys.  Either the build grows b_bits until no
bucket overflows (planar), or the probe follows a full row into the next
one (128-byte rows); both ways the index is exact.

`lookup` picks an implementation from MCTX_LOOKUP (auto|planar|fused|
join):
  planar = the plain bucket-row gather (lookup_planar);
  fused  = the lookup kernel (kernels/lookup.py, csrc/lookup.cu), which
           takes its plain version for CPU tensors;
  join   = the sort-merge join (ops.sorted.lookup_join), no table;
  auto   = fused on a CUDA store; on the CPU, the JAX package's gate.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.timing import count, span
from . import kmer as kops
from . import sorted as sops

EPR = 32          # entries per row (per plane) of the planar table
OCC = 13          # target mean occupancy of the planar table
_EMPTY = np.uint32(0xFFFFFFFF)

IMPLS = ("auto", "planar", "fused", "join")
LOOKUP_IMPL = os.environ.get("MCTX_LOOKUP", "auto")

# the JAX package's CPU gate (fitted on its own device; kept unchanged
# for CPU stores): join iff one dispatch holds >= JOIN_MIN_Q queries
# against a store of at most JOIN_MAX_STORE keys and fewer than twice
# the queries
HCHUNK = 1 << 22   # queries per dispatch of the planar gather and the join
JOIN_MIN_Q = 1 << 20
JOIN_MAX_STORE = 32 << 20


def _hash_np(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Host mirror of kops.kmer_hash (must match bit for bit)."""
    gold = np.uint64(0x9E3779B97F4A7C15)
    c1 = np.uint64(0xBF58476D1CE4E5B9)
    c2 = np.uint64(0x94D049BB133111EB)

    def sm(x):
        with np.errstate(over="ignore"):
            x = x + gold
            x = (x ^ (x >> np.uint64(30))) * c1
            x = (x ^ (x >> np.uint64(27))) * c2
            return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        h = sm(keys[:, 0] ^ (np.uint64(seed) * gold))
        for w in range(1, keys.shape[1]):
            h = sm(h ^ keys[:, w])
    return h


def build_table(keys_np: np.ndarray, b_bits: int | None = None):
    """Build the planar table from live (n, W) uint64 keys (host numpy).

    Returns (table (B, P*EPR) uint32, b_bits).  Grows b_bits until no
    bucket exceeds EPR entries; stores above 32M keys target OCC=20.
    """
    n, W = keys_np.shape
    occ = OCC if n <= (32 << 20) else 20
    if b_bits is None:
        b_bits = max(1, int(np.ceil(np.log2(max(n, 1) / occ))) if n > occ
                     else 1)

        # pre-bump b_bits until the expected number of overflowing
        # buckets, B x P(Poisson(n/B) > EPR) by a Chernoff bound, is < 0.01
        def _exp_overflow(bb):
            lam = n / (1 << bb)
            a = EPR + 1.0
            if lam <= 0:
                return 0.0
            return (1 << bb) * math.exp(a * math.log(math.e * lam / a)
                                        - lam)

        while _exp_overflow(b_bits) > 0.01:
            b_bits += 1
    h = _hash_np(keys_np)
    P = 2 * W + 1
    while True:
        B = 1 << b_bits
        bucket = (h >> np.uint64(64 - b_bits)).astype(np.int64)
        occ = np.bincount(bucket, minlength=B)
        if occ.max() <= EPR:
            break
        b_bits += 1
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    start = np.searchsorted(sb, np.arange(B))
    rank = (np.arange(n) - start[sb]).astype(np.int64)
    table = np.full((B, P * EPR), _EMPTY, np.uint32)
    for w in range(W):
        kw = keys_np[order, w]
        table[sb, (2 * w) * EPR + rank] = (kw >> np.uint64(32)).astype(
            np.uint32)
        table[sb, (2 * w + 1) * EPR + rank] = kw.astype(np.uint32)
    table[sb, 2 * W * EPR + rank] = order.astype(np.uint32)
    return table, b_bits


def query_planes(q: torch.Tensor):
    """(Q, W) int64 words -> 2W (Q,) int32 limbs [w0_hi, w0_lo, ...]."""
    out = []
    for w in range(q.shape[1]):
        out.append((q[:, w] >> 32).to(torch.int32))
        out.append(q[:, w].to(torch.int32))
    return out


def lookup_planar(table: torch.Tensor, queries: torch.Tensor, b_bits: int,
                  W: int):
    """(idx int32, found bool) per query key (..., W) via one bucket-row
    gather of the planar table (B, P*EPR) int32.  idx is the store row
    when found, else 0; sentinel queries are never found."""
    qshape = queries.shape[:-1]
    q = queries.reshape(-1, W)
    bkt = kops.srl(kops.kmer_hash(q), 64 - b_bits)
    row = table[bkt]                          # (Q, P*EPR) one gather
    eq = torch.ones((q.shape[0], EPR), dtype=torch.bool, device=q.device)
    for p, qp in enumerate(query_planes(q)):
        eq &= row[:, p * EPR:(p + 1) * EPR] == qp[:, None]
    found = eq.any(dim=-1) & ~sops.is_sentinel(q)
    ridx = row[:, 2 * W * EPR:]
    idx = torch.where(eq, ridx, 0).amax(dim=-1) * found
    return idx.to(torch.int32).reshape(qshape), found.reshape(qshape)


# ---------------------------------------------------------------------------
# per-store caches, keyed on the key tensor itself (checked with `is`: a
# bare id() can be reused once a tensor is freed)
# ---------------------------------------------------------------------------

_cache_store: dict = {}
_cache32: dict = {}
CACHE_ENTRIES = 8   # tables kept, the oldest dropped first: enough for
                    # the shards of a sharded lookup beside their store


def _live_host_keys(keys: torch.Tensor) -> np.ndarray:
    keys_np = keys.cpu().numpy().view(np.uint64)
    live = ~np.all(keys_np == np.uint64(0xFFFFFFFFFFFFFFFF), axis=-1)
    # live records are compacted at the front (store invariant)
    return keys_np[:int(live.sum())]


def _host_build(build):
    """A table build of the live keys copied to the host (numpy), the
    table copied back to the keys' device."""
    def run(keys: torch.Tensor):
        live = _live_host_keys(keys)
        table, b_bits = build(live)
        return (torch.from_numpy(table.view(np.int32)).to(keys.device),
                b_bits, len(live))
    return run


def _build32(keys: torch.Tensor):
    """The 128-byte-row table: on the card for CUDA keys (the live count
    the one word that comes to the host before the build), else numpy."""
    from .kernels import lookup as klookup
    if keys.device.type != "cuda":
        return _host_build(klookup.build_table32)(keys)
    n = int((~sops.is_sentinel(keys)).sum())
    table, b_bits, rounds = klookup.build_table32_fused(keys[:n])
    count("table.card")
    count("table.rounds", rounds)
    return table, b_bits, n


def _cached(cache: dict, keys: torch.Tensor, build):
    ck = (id(keys), tuple(keys.shape))
    hit = cache.get(ck)
    if hit is not None and hit[0] is keys:
        return hit[1], hit[2]
    with span("table", keys.device):
        table_t, b_bits, n = build(keys)
    count("table.keys", n)              # a cache hit builds and counts none
    while len(cache) >= CACHE_ENTRIES:
        cache.pop(next(iter(cache)))
    cache[ck] = (keys, table_t, b_bits)
    return table_t, b_bits


def get_index_for(keys: torch.Tensor):
    """Cached (planar table on keys' device, b_bits) for a key tensor.
    Keys beyond the live prefix are sentinels and left out."""
    return _cached(_cache_store, keys, _host_build(build_table))


def get_index32_for(keys: torch.Tensor):
    """Cached (128-byte-row table on keys' device, b_bits) for the lookup
    kernel, built on the keys' device."""
    return _cached(_cache32, keys, _build32)


def _pick_impl(n_store: int, n_queries: int, device="cpu") -> str:
    if LOOKUP_IMPL not in IMPLS:
        raise ValueError(f"MCTX_LOOKUP={LOOKUP_IMPL!r}: expected one of "
                         f"{', '.join(IMPLS)}")
    if LOOKUP_IMPL != "auto":
        return LOOKUP_IMPL
    if torch.device(device).type == "cuda":
        return "fused"
    # the join re-sorts the store per HCHUNK of queries, so the gate
    # compares the store against one dispatch, not the whole batch
    q_dispatch = min(n_queries, HCHUNK)
    if (q_dispatch >= JOIN_MIN_Q and n_store <= JOIN_MAX_STORE
            and n_store < 2 * q_dispatch):
        return "join"
    return "planar"


def _chunked(fn, q: torch.Tensor):
    if q.shape[0] <= HCHUNK:
        return fn(q)
    parts = [fn(q[s:s + HCHUNK]) for s in range(0, q.shape[0], HCHUNK)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def lookup(keys: torch.Tensor, queries: torch.Tensor):
    """(idx int32, found bool) per query key (..., W) against the sorted
    key tensor `keys` (N, W): idx is the store row when found, else 0.
    Builds or fetches the table for `keys`."""
    W = keys.shape[1]
    qshape = queries.shape[:-1]
    q = queries.reshape(-1, W)
    impl = _pick_impl(keys.shape[0], q.shape[0], keys.device)
    if impl == "join":
        idx, found = _chunked(lambda c: sops.lookup_join(keys, c), q)
    elif impl == "fused":
        from .kernels import lookup as klookup
        table, b_bits = get_index32_for(keys)
        idx, found = klookup.lookup_fused(table, q, b_bits, W)
    else:
        table, b_bits = get_index_for(keys)
        idx, found = _chunked(
            lambda c: lookup_planar(table, c, b_bits, W), q)
    return idx.reshape(qshape), found.reshape(qshape)

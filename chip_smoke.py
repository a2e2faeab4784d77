#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mccortex_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device, nvcc
and PyTorch built for CUDA.  Phases, each fatal on failure:

1. probe: torch and CUDA versions, the card's name and power limit;
2. build the kernels (csrc/*.cu) with nvcc, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, exact (integer outputs: tolerance 0),
   with CUDA-event times of both, the least time the card could take
   (bound) and, where one PyTorch call computes the same function, that
   call's time.  The sort kernels (tile sort, tail, butterfly, merge
   level) and the sorts and merges built from them (sort_planes,
   merge_planes, sort_planes_mp) run at an epoch's shape (k=31 and k=63)
   and an LSM merge's (2 x 4M records), to the tie contract of
   ops/kernels/bitonic.py, beside torch.sort.  The lookup kernel runs at
   W=1 and W=2 against a store of the E. coli graph's size (9.2M keys),
   with present, absent and sentinel queries, at a walker's batch (4096)
   and a bulk batch (Q = N); beside it the plain bucket-row gather
   (lookup_planar) and the sort-merge joins (lookup_join, variants lax
   and mp) are timed, and the kernel's row bytes/s are set against the
   card's 3.35 TB/s;
4. the build path at real size: `mctx-torch build -k 31` (the CLI entry
   point, called in-process so the kernels' launch counts are visible)
   on 20x of 150 bp reads of a synthetic 4.6 Mb E. coli-sized genome,
   under each sort engine (lax, mp, bitonic); the lax .ctx is held
   against a numpy count of the reads' kmers and the others against its
   bytes.  Then the same reads as mate pairs with planted duplicate
   pairs, built with -p through --seq2 and through --seqi (equal bytes,
   the removed count and the kmers held against a numpy rendering of
   the rule), and once more with --intersect against the graph of the
   genome's own kmers;
4b. the graph path on that .ctx: `mctx-torch clean -T -U`, then
   `mctx-torch unitigs` of the cleaned graph, each of which must launch
   the lookup kernel; the cleaned graph must be a subset of the raw one
   with its coverage, hold every kmer its edges point at, and be smaller;
   the unitigs' kmers must be the cleaned kmer set, each once.  Prints
   each command's wall time and its split (table build on the host,
   adjacency, pointer doubling, extraction), the cleaning threshold and
   the genome and non-genome kmers kept;
5. byte identity: a 2-colour build of a 200 kb genome at k=31 and k=63
   (k=31 under every sort engine), a --graph + --seq2 -p build, then at
   k=31 `clean -T -U`, `unitigs` and `unitigs --gfa`, each on the card
   and with the plain versions on the CPU.

Prints a JSON line of per-kernel results, then `{"ok": true, "device":
...}` as its last line.  Exits non-zero, printing no result, when CUDA
is unavailable or the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K_MAIN = 31
GENOME_BP = 4_600_000     # phase 4's genome, E. coli-sized
MERGE_ITEM = 1 << 22      # records a side of phase 3's LSM merge
ENGINE_KERNELS = {        # what a build must launch under each sort engine
    "lax": ("frontend", "segreduce", "mergepath"),
    "mp": ("frontend", "segreduce", "mergepath", "bitonic_blocksort",
           "mergelevel"),
    "bitonic": ("frontend", "segreduce", "bitonic_blocksort", "bitonic_tail",
                "bitonic_butterfly")}
HBM_BYTES_S = 3.35e12     # H100 SXM device memory, data sheet
ALU_OPS_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
SIGN = -(1 << 63)
CHAR_CODES = np.full(256, 4, np.uint8)
CHAR_CODES[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps calls (CUDA events).  A sleep
    kernel first holds the stream while the host queues every call, so
    the events time the device work back to back, not the host's
    launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def row(err, ms, plain_ms, nbytes, nops, library_ms=None) -> dict:
    """One kernel's entry.  bound_ms is the larger of its bytes (every
    input read once, every output written once) over the card's memory
    rate and its 32-bit integer operations (an estimate of the compares,
    shifts and adds the function needs on these inputs) over the card's
    rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / ALU_OPS_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def keys64(planes):
    """The two key planes of (np, M) int32 records packed into one int64
    word a record, signed order = the planes' unsigned order."""
    return ((planes[0].long() << 32) | (planes[1].long() & 0xFFFFFFFF)) ^ SIGN


# ---------------------------------------------------------------------------
# synthetic data (numpy, seeded)
# ---------------------------------------------------------------------------

def genome_and_reads(gsize: int, cov: float, seed: int, rlen: int = 150,
                     err: float = 0.003):
    """Random genome with planted repeat families, and reads sampled from
    it with substitutions (the recipe of scripts/scale_test.py)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, gsize, dtype=np.uint8)
    n_fam = max(4, gsize // 300_000)
    for _ in range(n_fam):
        ulen = int(rng.integers(500, 1500))
        unit = rng.integers(0, 4, ulen, dtype=np.uint8)
        for _ in range(24):
            p = int(rng.integers(0, gsize - ulen))
            genome[p:p + ulen] = unit
    nreads = int(gsize * cov / rlen)
    starts = rng.integers(0, gsize - rlen, nreads)
    reads = np.lib.stride_tricks.sliding_window_view(
        genome, rlen)[starts].copy()
    nerr = int(err * reads.size)
    ei = rng.integers(0, nreads, nerr)
    ej = rng.integers(0, rlen, nerr)
    reads[ei, ej] = rng.integers(0, 4, nerr, dtype=np.uint8)
    return genome, reads, starts


def write_fastq(path: str, reads: np.ndarray, quals: np.ndarray | None = None):
    seqs = np.frombuffer(b"ACGTN", np.uint8)[reads]
    if quals is None:
        quals = np.full(reads.shape, 40, np.uint8)
    qchars = (quals + 33).astype(np.uint8)
    with open(path, "wb") as fh:
        for i in range(reads.shape[0]):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
                                              qchars[i].tobytes()))


def canonical_kmers_np(seqs: np.ndarray, k: int) -> np.ndarray:
    """Canonical k <= 31 kmers (uint64) of every window of every row of
    an N-free (n, L) code array, row-major."""
    n, L = seqs.shape
    nw = L - k + 1
    fw = np.zeros((n, nw), np.uint64)
    rc = np.zeros((n, nw), np.uint64)
    top = np.uint64(2 * k - 2)
    for t in range(k):
        b = seqs[:, t:t + nw].astype(np.uint64)
        fw = (fw << np.uint64(2)) | b
        rc = (rc >> np.uint64(2)) | ((np.uint64(3) - b) << top)
    return np.minimum(fw, rc).reshape(-1)


def valid_windows_np(reads: np.ndarray, k: int) -> int:
    bad = np.concatenate([np.zeros((reads.shape[0], 1), np.int64),
                          np.cumsum(reads >= 4, axis=1)], axis=1)
    L = reads.shape[1]
    return int((bad[:, k:] - bad[:, :L - k + 1] == 0).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, results):
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import frontend, mergepath, segreduce

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    # front-end: one batch of 2048 reads of 150 bp (some shorter, some N)
    B, L = 2048, 150
    bases_np = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases_np[rng.random((B, L)) < 0.005] = 4
    lens = rng.integers(20, L + 1, size=B)
    lens[: B // 2] = L
    bases_np[np.arange(L)[None, :] >= lens[:, None]] = 4
    bases = torch.from_numpy(bases_np).to(dev)
    for k in (K_MAIN, 63):
        got = torch.stack(frontend.records_fused(bases, k))
        want = torch.stack(frontend.records_plain(bases, k))
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            fail(f"frontend k={k}: kernel != plain (max abs err {err})")
        ms = time_ms(torch, lambda: frontend.records_fused(bases, k))
        plain = time_ms(torch, lambda: frontend.records_plain(bases, k), 5)
        print(f"frontend k={k} B={B} L={L}: exact; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms")
        if k == K_MAIN:
            results["frontend"] = row(
                err, ms, plain, nbytes_of(bases, got),
                B * L * (16 + 8 * got.shape[0] // 2))

    # segreduce, epoch shape: the sorted k=31 records of that batch
    Lv = L - K_MAIN + 1
    planes = torch.stack(frontend.records_fused(bases, K_MAIN))
    epoch31 = planes[:, :, :Lv].reshape(3, B * Lv).contiguous()
    planes = epoch31[:, sops.argsort_planes(epoch31[:2])].contiguous()
    keys, ors = planes[:2], planes[2:]

    def check_segreduce(label, keys, sums, ors):
        got = segreduce.segreduce_compact_multi(keys, sums, ors)
        want = segreduce.segreduce_plain(keys, sums, ors)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, g.reshape(-1), w.reshape(-1))
                  for g, w in zip(got, want))
        if err:
            fail(f"segreduce {label}: kernel != plain (max abs err {err})")
        ms = time_ms(torch,
                     lambda: segreduce.segreduce_compact_multi(keys, sums, ors))
        plain = time_ms(torch,
                        lambda: segreduce.segreduce_plain(keys, sums, ors), 5)
        print(f"segreduce {label}: n={int(got[4])} exact; kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms")
        # per record: the key compare, the sums and ORs, the scan
        return row(err, ms, plain, nbytes_of(keys, sums, ors, *got),
                   keys.shape[1] * (keys.shape[0] + sums.shape[0]
                                    + ors.shape[0] + 4))

    empty = torch.empty((0, keys.shape[1]), dtype=torch.int32, device=dev)
    results["segreduce"] = check_segreduce(
        f"epoch M={keys.shape[1]} NS=0 NO=1", keys, empty, ors)

    # segreduce, merge shape (W=1, C=2): duplicates across two inputs, one
    # run of 100000 records crossing many blocks, a sentinel tail
    M = MERGE_ITEM
    pool = np.unique(rng.integers(0, 1 << 62, size=M // 2, dtype=np.uint64))
    kv = np.sort(np.concatenate([
        pool[rng.integers(0, len(pool), M - 100_000 - M // 10)],
        np.full(100_000, pool[len(pool) // 2], np.uint64)]))
    kv = np.concatenate([kv, np.full(M // 10, np.uint64(2**64 - 1))])
    kp = np.stack([(kv >> np.uint64(32)).astype(np.uint32),
                   kv.astype(np.uint32)]).view(np.int32)
    keys = torch.from_numpy(kp).to(dev)
    sums = torch.from_numpy(rng.integers(0, 1000, (2, M)).astype(np.int32)
                            ).to(dev)
    ors = torch.from_numpy(rng.integers(0, 256, (2, M)).astype(np.int32)
                           ).to(dev)
    check_segreduce(f"merge M={M} NS=2 NO=2", keys, sums, ors)

    # merge path: two 4M-record sorted items (2 key planes, covg, edges),
    # unique within each, shared keys across, sentinel tails
    Mh = MERGE_ITEM

    def item():
        live = Mh - Mh // 8
        kv = np.unique(rng.integers(0, 1 << 40, size=live + live // 4,
                                    dtype=np.uint64))[:live]
        kv = np.concatenate([kv, np.full(Mh - len(kv), np.uint64(2**64 - 1))])
        p = np.stack([(kv >> np.uint64(32)).astype(np.uint32),
                      kv.astype(np.uint32),
                      rng.integers(1, 100, Mh).astype(np.uint32),
                      rng.integers(0, 256, Mh).astype(np.uint32)])
        return torch.from_numpy(p.view(np.int32)).to(dev)

    a, b = item(), item()
    got = mergepath.merge_path_planes(a, b, num_keys=2)
    want = mergepath.merge_plain(a, b, 2)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        fail(f"mergepath: kernel != plain (max abs err {err})")
    ms = time_ms(torch, lambda: mergepath.merge_path_planes(a, b, 2))
    plain = time_ms(torch, lambda: mergepath.merge_plain(a, b, 2), 5)
    print(f"mergepath Ma=Mb={Mh} np=4: exact (every plane, element for "
          f"element); kernel {ms:.4f} ms, plain {plain:.4f} ms")
    ab64 = torch.cat([keys64(a), keys64(b)])
    lib = time_ms(torch, lambda: torch.sort(ab64, stable=True), 5)
    print(f"mergepath: torch.sort of the {2 * Mh} concatenated 64-bit keys "
          f"(the merged order, no gather) {lib:.4f} ms")
    results["mergepath"] = row(err, ms, plain, nbytes_of(a, b, got),
                               2 * Mh * MERGE_OPS(2), lib)
    del ab64
    return dict(epoch31=epoch31, bases=bases, a=a, b=b)


def MERGE_OPS(nk: int) -> int:
    """Operations per merged record: its share of the diagonal searches
    and one key compare of nk words on each side."""
    return 2 * nk + 6


def phase_sorts(torch, results, shapes):
    """The sort kernels and the sorts and merges built from them, against
    their plain versions, to the tie contract: tile sort, merge level and
    sort_planes_mp equal a stable sort on every plane; tail, butterfly,
    sort_planes and merge_planes equal their plain versions (the same
    network) on every plane, and a stable sort on the key planes."""
    from mccortex_tpu_torch.graph import build as gbuild
    from mccortex_tpu_torch.ops import kmer as kops
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import bitonic, mergepath

    T = bitonic.TILE
    logT = T.bit_length() - 1
    sorts = []

    def exact(label, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            fail(f"{label}: kernel != plain (max abs err {err})")
        return err

    def stable(x, nk):
        return x[:, sops.argsort_planes(x[:nk])]

    def cmp_ops(nk):           # one compare-exchange: nk words a side
        return 2 * nk + 4

    keys63, ebyte, _v = gbuild.reads_to_records(shapes["bases"], 63)
    Lv = shapes["bases"].shape[1] - 63 + 1
    epoch63 = torch.cat([
        kops.to_planes(keys63[:, :Lv].reshape(-1, 2)),
        ebyte[:, :Lv].reshape(1, -1).to(torch.int32)]).contiguous()
    for label, x, nk in (("epoch k=31", shapes["epoch31"], 2),
                         ("epoch k=63", epoch63, 4)):
        np_, M = x.shape
        if M % (2 * T):
            fail(f"{label}: M = {M} is not a multiple of two tiles")
        tag = f"{label} M={M} np={np_} nk={nk}"
        lib_ok = nk == 2
        k64 = keys64(x) if lib_ok else None

        # tile sort, both direction rules
        want = bitonic.block_sort_plain(x, nk, True, T)
        err = exact(f"blocksort {tag}", bitonic.block_sort(x, nk, True), want)
        alt = bitonic.block_sort(x, nk, False)
        exact(f"blocksort alternating {tag}", alt,
              bitonic.block_sort_plain(x, nk, False, T))
        runs = want
        ms = time_ms(torch, lambda: bitonic.block_sort(x, nk, True))
        plain = time_ms(torch,
                        lambda: bitonic.block_sort_plain(x, nk, True, T), 5)
        lib = time_ms(torch, lambda: torch.sort(k64.view(-1, T), dim=1,
                                                stable=True), 5) \
            if lib_ok else None
        print(f"blocksort {tag}: exact (stable per tile); kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, torch.sort of the tiles' 64-bit "
              f"keys {lib if lib is None else round(lib, 4)} ms")
        if lib_ok:
            results["bitonic_blocksort"] = row(
                err, ms, plain, 2 * nbytes_of(x),
                M // 2 * (logT * (logT + 1) // 2) * cmp_ops(nk + 1), lib)

        # tail and butterfly of the first merge stage, on the alternating
        # tiles
        bf = bitonic.butterfly(alt.clone(), nk, T, 2 * T, False)
        err_b = exact(f"butterfly {tag}", bf,
                      bitonic.cmpx_plain(alt, nk, T, 2 * T, False))
        err_t = exact(f"tail {tag}", bitonic.tail(bf, nk, 2 * T, False),
                      bitonic.tail_plain(bf, nk, 2 * T, False, T))
        # in place: timed on a fresh copy each call, less the copy's time
        ms_b = time_ms(torch, lambda: bitonic.butterfly(alt.clone(), nk, T,
                                                        2 * T, False)) \
            - time_ms(torch, alt.clone)
        plain_b = time_ms(torch, lambda: bitonic.cmpx_plain(alt, nk, T, 2 * T,
                                                            False), 5)
        ms_t = time_ms(torch, lambda: bitonic.tail(bf, nk, 2 * T, False))
        plain_t = time_ms(torch, lambda: bitonic.tail_plain(bf, nk, 2 * T,
                                                            False, T), 5)
        print(f"butterfly {tag} j={T}: exact; kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms")
        print(f"tail {tag} k={2 * T}: exact; kernel {ms_t:.4f} ms, plain "
              f"{plain_t:.4f} ms")
        if lib_ok:
            results["bitonic_butterfly"] = row(
                err_b, ms_b, plain_b, 2 * nbytes_of(x), M // 2 * cmp_ops(nk))
            results["bitonic_tail"] = row(
                err_t, ms_t, plain_t, 2 * nbytes_of(x),
                M // 2 * logT * cmp_ops(nk))

        # one merge level over the sorted tiles, and the last of the tree
        err = exact(f"mergelevel {tag} R={T}", mergepath.merge_level(runs, nk, T),
                    mergepath.merge_level_plain(runs, nk, T))
        ms = time_ms(torch, lambda: mergepath.merge_level(runs, nk, T))
        plain = time_ms(torch,
                        lambda: mergepath.merge_level_plain(runs, nk, T), 5)
        r64 = keys64(runs) if lib_ok else None
        lib = time_ms(torch, lambda: torch.sort(r64.view(-1, 2 * T), dim=1,
                                                stable=True), 5) \
            if lib_ok else None
        print(f"mergelevel {tag} R={T}: exact (stable); kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, torch.sort of the pairs' 64-bit keys "
              f"{lib if lib is None else round(lib, 4)} ms")
        if lib_ok:
            results["mergelevel"] = row(err, ms, plain, 2 * nbytes_of(x),
                                        M * MERGE_OPS(nk), lib)

        # the whole sorts
        want = stable(x, nk)
        exact(f"sort_planes_mp {tag}", mergepath.sort_planes_mp(x, nk), want)
        exact(f"sort_planes_mp_plain {tag}",
              mergepath.sort_planes_mp_plain(x, nk), want)
        Mp = bitonic.padded_length(M)
        xp = bitonic.pad_planes(x, nk, Mp)
        got = bitonic.sort_planes(xp, nk)
        exact(f"sort_planes {tag}", got, bitonic.sort_planes_plain(xp, nk))
        check_up_to_ties(torch, sops, f"sort_planes {tag}", got[:, :M], want,
                         nk)
        ms_mp = time_ms(torch, lambda: mergepath.sort_planes_mp(x, nk), 10)
        ms_bt = time_ms(torch, lambda: gbuild._sort_planes32(x, nk, "bitonic"),
                        10)
        ms_lax = time_ms(torch, lambda: gbuild._sort_planes32(x, nk, "lax"),
                         10)
        lib = time_ms(torch, lambda: torch.sort(k64, stable=True), 10) \
            if lib_ok else None
        bound = 2 * nbytes_of(x) / HBM_BYTES_S * 1e3
        print(f"sort {tag}: sort_planes_mp exact (stable, every plane) "
              f"{ms_mp:.4f} ms; bitonic sort_planes (padded to {Mp}) exact to "
              f"the tie contract {ms_bt:.4f} ms; the lax engine (torch.sort "
              f"+ gather) {ms_lax:.4f} ms; torch.sort of the 64-bit keys "
              f"alone {lib if lib is None else round(lib, 4)} ms; one read "
              f"and one write of the records {bound:.4f} ms")
        sorts.append(dict(shape=tag, sort_planes_mp_ms=ms_mp,
                          bitonic_sort_planes_ms=ms_bt, lax_engine_ms=ms_lax,
                          torch_sort_keys_ms=lib, bound_ms=bound))

    # an LSM merge: two sorted items of 4M records
    a, b = shapes["a"], shapes["b"]
    Mh = a.shape[1]
    both = torch.cat([a, b], dim=1)
    want = mergepath.merge_plain(a, b, 2)
    exact("mergelevel LSM merge", mergepath.merge_level(both, 2, Mh), want)
    exact("mergelevel LSM merge against its plain version",
          mergepath.merge_level_plain(both, 2, Mh), want)
    got = bitonic.merge_planes(a, b, 2)
    exact("merge_planes LSM merge", got, bitonic.merge_planes_plain(a, b, 2))
    check_up_to_ties(torch, sops, "merge_planes LSM merge", got, want, 2)
    ms_ml = time_ms(torch, lambda: mergepath.merge_level(both, 2, Mh), 10)
    ms_mp = time_ms(torch, lambda: mergepath.merge_path_planes(a, b, 2), 10)
    ms_bt = time_ms(torch, lambda: bitonic.merge_planes(a, b, 2), 5)
    bitonic_in = torch.cat([a, b.flip(1)], dim=1)
    ms_t = time_ms(torch, lambda: bitonic.tail(bitonic_in, 2, 2 * Mh, True),
                   10)
    ms_b = time_ms(torch, lambda: bitonic.butterfly(bitonic_in.clone(), 2, Mh,
                                                    2 * Mh, True), 10) \
        - time_ms(torch, bitonic_in.clone, 10)
    bound = 2 * nbytes_of(both) / HBM_BYTES_S * 1e3
    print(f"LSM merge Ma=Mb={Mh} np=4 nk=2: merge_level (one pair) exact "
          f"{ms_ml:.4f} ms; merge_path_planes {ms_mp:.4f} ms; bitonic "
          f"merge_planes exact to the tie contract {ms_bt:.4f} ms (of it "
          f"one tail {ms_t:.4f} ms, one butterfly {ms_b:.4f} ms); one read "
          f"and one write {bound:.4f} ms")
    sorts.append(dict(shape=f"LSM merge Ma=Mb={Mh} np=4 nk=2",
                      merge_level_ms=ms_ml, merge_path_planes_ms=ms_mp,
                      bitonic_merge_planes_ms=ms_bt, tail_ms=ms_t,
                      butterfly_ms=ms_b, bound_ms=bound))
    return sorts


def check_up_to_ties(torch, sops, label, got, want, nk):
    """Key planes equal element for element; whole records the same
    multiset within every run of equal keys (both sorted on all planes)."""
    if not torch.equal(got[:nk], want[:nk]):
        fail(f"{label}: key planes differ from the stable sort's")
    if not torch.equal(got[:, sops.argsort_planes(got)],
                       want[:, sops.argsort_planes(want)]):
        fail(f"{label}: records differ from the stable sort's as a multiset")


N_STORE = 9_165_696      # distinct kmers of the phase-4 E. coli build


def lookup_store(rng, n: int, W: int) -> np.ndarray:
    """n sorted, unique, valid (word 0 < 2**62) random keys (n, W)."""
    if W == 1:
        kv = np.unique(rng.integers(0, 1 << 62, size=n + n // 50,
                                    dtype=np.uint64))
        return np.sort(rng.choice(kv, n, replace=False))[:, None]
    w = np.stack([rng.integers(0, 1 << 62, size=n, dtype=np.uint64),
                  rng.integers(0, 2**64, size=n, dtype=np.uint64)], axis=1)
    return w[np.lexsort(w.T[::-1])]


def lookup_queries(rng, keys: np.ndarray, Q: int) -> np.ndarray:
    """60 % present, 35 % absent (random words), 5 % sentinel."""
    W = keys.shape[1]
    q = keys[rng.integers(0, len(keys), Q)]
    r = rng.random(Q)
    absent = r >= 0.6
    q[absent] = rng.integers(0, 1 << 62, size=(int(absent.sum()), W),
                             dtype=np.uint64)
    q[r >= 0.95] = np.uint64(2**64 - 1)
    return q


def phase_lookup(torch, results):
    from mccortex_tpu_torch.ops import hashidx
    from mccortex_tpu_torch.ops import kmer as kops
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import lookup

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for W in (1, 2):
        t0 = time.perf_counter()
        keys_np = lookup_store(rng, N_STORE, W)
        t128, b128 = lookup.build_table128(keys_np)
        tplan, bplan = hashidx.build_table(keys_np)
        keys = torch.from_numpy(keys_np.view(np.int64)).to(dev)
        t128 = torch.from_numpy(t128.view(np.int32)).to(dev)
        tplan = torch.from_numpy(tplan.view(np.int32)).to(dev)
        print(f"lookup W={W}: store of {N_STORE} keys, 128-lane table "
              f"2^{b128} rows, planar table 2^{bplan} rows (host build "
              f"{time.perf_counter() - t0:.1f}s)")
        for Q in (4096, N_STORE):
            q = torch.from_numpy(lookup_queries(rng, keys_np, Q).view(
                np.int64)).to(dev)
            idx, found = lookup.lookup_fused(t128, q, b128, W)
            want = lookup.lookup_plain(t128, q, b128, W)
            torch.cuda.synchronize()
            err = max(max_abs_err(torch, idx, want[0]),
                      max_abs_err(torch, found, want[1]))
            if err:
                fail(f"lookup W={W} Q={Q}: kernel != plain "
                     f"(max abs err {err})")
            hit = found.nonzero()[:, 0]
            if not torch.equal(keys[idx[hit].long()], q[hit]):
                fail(f"lookup W={W} Q={Q}: a found row holds another key")
            for other in (hashidx.lookup_planar(tplan, q, bplan, W),
                          sops.lookup_join(keys, q),
                          sops.lookup_join(keys, q, variant="mp")):
                if not (torch.equal(other[0], idx) and
                        torch.equal(other[1], found)):
                    fail(f"lookup W={W} Q={Q}: planar or a join disagrees")
            reps = 20 if Q < N_STORE else 10
            ms = time_ms(torch, lambda: lookup.lookup_fused(t128, q, b128, W),
                         reps)
            plain = time_ms(torch,
                            lambda: lookup.lookup_plain(t128, q, b128, W), 5)
            planar = time_ms(
                torch, lambda: hashidx.lookup_planar(tplan, q, bplan, W), 5)
            join = time_ms(torch, lambda: sops.lookup_join(keys, q), 3)
            join_mp = time_ms(
                torch, lambda: sops.lookup_join(keys, q, variant="mp"), 3)
            # sentinel queries skip the probe: rows read = non-sentinel
            rows = int((q != -1).any(dim=1).sum())
            rate = rows * 512 / (ms * 1e-3)
            print(f"lookup W={W} Q={Q}: exact ({int(found.sum())} found); "
                  f"kernel {ms:.4f} ms ({Q / ms / 1e3:.2f}M lookups/s, row "
                  f"bytes {rate / 1e9:.1f} GB/s = "
                  f"{100 * rate / HBM_BYTES_S:.1f} % of 3.35 TB/s), plain "
                  f"{plain:.4f} ms, lookup_planar {planar:.4f} ms, "
                  f"lookup_join {join:.4f} ms, lookup_join mp "
                  f"{join_mp:.4f} ms")
            if W == 1 and Q == N_STORE:
                ks, qs = keys[:, 0] ^ SIGN, (q[:, 0] ^ SIGN).contiguous()
                lib = time_ms(torch, lambda: torch.searchsorted(ks, qs), 5)
                print(f"lookup W={W} Q={Q}: torch.searchsorted of the "
                      f"queries in the sorted keys {lib:.4f} ms")
                # every bucket row that a non-sentinel query names, once;
                # the queries, idx and found; per query the hash and 128
                # lane compares
                live = q[(q != -1).any(dim=1)]
                named = int(torch.unique(kops.srl(
                    kops.kmer_hash(live), 64 - b128)).numel())
                results["lookup"] = row(
                    err, ms, plain, named * 512 + nbytes_of(q, idx, found),
                    Q * (24 + 128), lib)
                del live
                del ks, qs
        del keys, t128, tplan, q, idx, found, want
        torch.cuda.empty_cache()


def run_cli(argv):
    """The port's CLI entry point in-process; returns its stderr."""
    from mccortex_tpu_torch.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = main(argv)
    err = buf.getvalue()
    sys.stderr.write(err)
    if rc != 0:
        fail(f"mctx-torch {' '.join(argv)} exited {rc}")
    return err


def build_under(engine: str, argv, required=None):
    """One `mctx-torch build` through the CLI under a sort engine, with
    the launch counts set to 0 just before and read just after.  Returns
    (stderr, wall seconds, launches)."""
    from mccortex_tpu_torch.graph import build as gbuild
    from mccortex_tpu_torch.ops.kernels import _build

    saved = gbuild.SORT_IMPL
    gbuild.SORT_IMPL = engine
    try:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        log = run_cli(argv)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        gbuild.SORT_IMPL = saved
    print(f"launches of mctx-torch build under MCTX_SORT={engine}: "
          f"{json.dumps(launches)}")
    for name in ENGINE_KERNELS[engine] if required is None else required:
        if launches.get(name, 0) <= 0:
            fail(f"the build under {engine} never launched the {name} kernel")
    for name in set(ENGINE_KERNELS["mp"] + ENGINE_KERNELS["bitonic"]) \
            - set(ENGINE_KERNELS[engine]):
        if launches.get(name, 0):
            fail(f"the build under {engine} launched the {name} kernel")
    return log, wall, launches


def build_seconds(log: str) -> float:
    m = re.search(r"built (\d+) kmers from (\d+) batches in ([\d.]+)s", log)
    return float(m.group(3)) if m else float("nan")


def count_kmers_np(reads: np.ndarray, k: int):
    want = [canonical_kmers_np(reads[s:s + 100_000], k)
            for s in range(0, len(reads), 100_000)]
    return np.unique(np.concatenate(want), return_counts=True)


def phase_main_path(torch, tmp, card):
    from mccortex_tpu_torch.io import ctx as ctxio

    t0 = time.perf_counter()
    genome, reads, starts = genome_and_reads(GENOME_BP, 20.0, seed=0)
    fq = os.path.join(tmp, "reads.fq")
    write_fastq(fq, reads)
    print(f"E. coli-sized input: {len(genome)} bp genome, {len(reads)} reads "
          f"x {reads.shape[1]} bp (made in {time.perf_counter() - t0:.1f}s)")
    obs = valid_windows_np(reads, K_MAIN)
    # lax runs first and last: the spread of two runs of one engine on a
    # shared host stands beside the differences between engines
    out, ref, launches = None, None, {}
    for turn, engine in enumerate(("lax", "mp", "bitonic", "lax")):
        path = os.path.join(tmp, f"ecoli_{turn}.ctx")
        log, wall, launches[engine] = build_under(
            engine, ["build", "-k", str(K_MAIN), "--sample", "ecoli", "--seq",
                     fq, path, "--device", "cuda"])
        build_s = build_seconds(log)
        print(f"main path on {card} under MCTX_SORT={engine}: mctx-torch "
              f"build wall {wall:.3f}s ({obs / wall / 1e6:.2f}M kmer-obs/s), "
              f"graph build {build_s:.3f}s ({obs / build_s / 1e6:.2f}M "
              f"kmer-obs/s), {obs} kmer-obs")
        if out is None:
            out, ref = path, open(path, "rb").read()
            continue
        if open(path, "rb").read() != ref:
            fail(f"the .ctx built under {engine} differs from the first lax "
                 f"one")
        os.remove(path)
    print(f"main path: the .ctx of {len(ref)} bytes is byte-identical under "
          f"lax, mp and bitonic")
    del ref

    h, keys, covg, _edges = ctxio.read_ctx(out)
    kv = keys[:, 0]
    if len(kv) == 0 or not (kv[1:] > kv[:-1]).all():
        fail("the .ctx keys are not strictly increasing")
    if int(covg.sum(dtype=np.uint64)) != obs:
        fail(f"sum of covg {int(covg.sum())} != {obs} kmer windows")
    ukeys, counts = count_kmers_np(reads, K_MAIN)
    if not (np.array_equal(ukeys, kv) and
            np.array_equal(counts, covg[:, 0].astype(np.int64))):
        fail("the .ctx kmers/coverage differ from the numpy count of the "
             "reads' kmers")
    # every genome kmer inside a read window free of substitutions
    rlen = reads.shape[1]
    changed = reads != np.lib.stride_tricks.sliding_window_view(
        genome, rlen)[starts]
    bad = np.concatenate([np.zeros((len(reads), 1), np.int32),
                          np.cumsum(changed, axis=1, dtype=np.int32)], axis=1)
    clean = bad[:, K_MAIN:] - bad[:, :rlen - K_MAIN + 1] == 0
    covered = np.zeros(len(genome) - K_MAIN + 1, bool)
    r, j = np.nonzero(clean)
    covered[starts[r] + j] = True
    gk = canonical_kmers_np(genome[None, :], K_MAIN)[covered]
    if not np.isin(gk, kv).all():
        fail("a genome kmer covered by an error-free read window is missing")
    print(f"main path: {len(kv)} kmers (numpy reference equal), "
          f"{int(covered.sum())} covered genome kmers all present")
    return launches, genome, reads, out


def start_tokens_np(reads: np.ndarray, k: int) -> np.ndarray:
    """(canonical start kmer, orientation) of every N-free read as one
    Python-hashable integer: the token of the PCR duplicate rule."""
    head = reads[:, :k].astype(np.uint64)
    fw = np.zeros(len(reads), np.uint64)
    rc = np.zeros(len(reads), np.uint64)
    for t in range(k):
        fw = (fw << np.uint64(2)) | head[:, t]
        rc = (rc >> np.uint64(2)) | ((np.uint64(3) - head[:, t])
                                     << np.uint64(2 * k - 2))
    return np.stack([np.minimum(fw, rc), (rc < fw).astype(np.uint64)], axis=1)


def phase_paired(torch, tmp, card, genome, reads):
    """The E. coli reads as mate pairs with planted duplicate pairs:
    `build -p` through --seq2 and through --seqi, and --intersect."""
    from mccortex_tpu_torch.io import ctx as ctxio

    rng = np.random.default_rng(5)
    npairs = len(reads) // 2
    r1, r2 = reads[0:2 * npairs:2].copy(), reads[1:2 * npairs:2].copy()
    planted = rng.choice(np.arange(1000, npairs), npairs // 20, replace=False)
    src = rng.integers(0, planted)          # an earlier pair, both mates
    order = np.argsort(planted)
    for i, j in zip(planted[order], src[order]):
        r1[i], r2[i] = r1[j], r2[j]
    # the rule, one pair after another: a pair goes when both mates' start
    # tokens were seen before as read starts; every read's tokens count
    t1 = [tuple(t) for t in start_tokens_np(r1, K_MAIN).tolist()]
    t2 = [tuple(t) for t in start_tokens_np(r2, K_MAIN).tolist()]
    seen, keep = set(), np.ones(npairs, bool)
    for i in range(npairs):
        keep[i] = not (t1[i] in seen and t2[i] in seen)
        seen.add(t1[i])
        seen.add(t2[i])
    ndrop = int((~keep).sum())
    if keep[planted].any() or ndrop < len(planted):
        fail("the reference of the PCR rule kept a planted duplicate pair")

    fq1, fq2 = os.path.join(tmp, "m1.fq"), os.path.join(tmp, "m2.fq")
    fqi = os.path.join(tmp, "mi.fq")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    inter = np.empty((2 * npairs, reads.shape[1]), np.uint8)
    inter[0::2], inter[1::2] = r1, r2
    write_fastq(fqi, inter)
    gfa = os.path.join(tmp, "genome.fa")
    with open(gfa, "wb") as fh:
        fh.write(b">genome\n" + np.frombuffer(b"ACGT", np.uint8)[genome]
                 .tobytes() + b"\n")

    base = ["build", "-k", str(K_MAIN), "-p", "--sample", "pairs"]
    outs = {}
    for name, task in (("seq2", ["--seq2", f"{fq1}:{fq2}"]),
                       ("seqi", ["--seqi", fqi])):
        outs[name] = os.path.join(tmp, f"pairs_{name}.ctx")
        log, wall, _ = build_under(
            "lax", base + task + [outs[name], "--device", "cuda"])
        m = re.search(r"removed (\d+) PCR duplicate reads", log)
        if not m or int(m.group(1)) != 2 * ndrop:
            fail(f"build -p {name}: removed {m and m.group(1)} reads, the "
                 f"rule removes {2 * ndrop}")
        print(f"paired build -p through --{name} on {card}: wall {wall:.3f}s, "
              f"graph build {build_seconds(log):.3f}s, removed {2 * ndrop} "
              f"reads = {ndrop} pairs ({len(planted)} planted, the rest start "
              f"where earlier reads start)")
    if open(outs["seq2"], "rb").read() != open(outs["seqi"], "rb").read():
        fail("the --seq2 and --seqi .ctx files differ")
    _h, keys, covg, _e = ctxio.read_ctx(outs["seq2"])
    ukeys, counts = count_kmers_np(np.concatenate([r1[keep], r2[keep]]),
                                   K_MAIN)
    if not (np.array_equal(ukeys, keys[:, 0]) and
            np.array_equal(counts, covg[:, 0].astype(np.int64))):
        fail("build -p: the .ctx differs from the numpy count of the kept "
             "pairs' kmers")
    print(f"paired build -p: --seq2 == --seqi byte for byte, {len(ukeys)} "
          f"kmers equal to the numpy count of the kept pairs")

    gctx = os.path.join(tmp, "genome.ctx")
    build_under("lax", ["build", "-k", str(K_MAIN), "--sample", "genome",
                        "--seq", gfa, gctx, "--device", "cuda"])
    ictx = os.path.join(tmp, "pairs_in_genome.ctx")
    log, wall, _ = build_under(
        "lax", base + ["--seq2", fq1, fq2, "--intersect", gctx, ictx,
                       "--device", "cuda"])
    hi_, ikeys, icovg, _e = ctxio.read_ctx(ictx)
    gk = np.unique(canonical_kmers_np(genome[None, :], K_MAIN))
    _h, gkeys, _c, _e = ctxio.read_ctx(gctx)
    if not np.array_equal(gkeys[:, 0], gk):
        fail("the genome's graph differs from the genome's kmers")
    shared = np.isin(ukeys, gk)
    if not (np.array_equal(ikeys[:, 0], ukeys[shared]) and
            np.array_equal(icovg[:, 0].astype(np.int64), counts[shared])):
        fail("--intersect did not keep exactly the kmers shared with the "
             "genome's graph, with their coverage")
    if not hi_.ginfo[0].cleaning.is_graph_intersection:
        fail("--intersect did not mark the header")
    print(f"build -p --intersect: wall {wall:.3f}s; kept {len(ikeys)} of "
          f"{len(ukeys)} kmers, exactly those among the genome's {len(gk)}")


def revcomp_np(x: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of k <= 31 kmers in uint64."""
    x = ~x
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        m = np.uint64(m)
        x = ((x & m) << np.uint64(sh)) | ((x >> np.uint64(sh)) & m)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def read_fasta_seqs(path: str) -> list:
    with open(path, "rb") as fh:
        return [l.strip() for l in fh if not l.startswith(b">")]


def check_unitig_partition(seqs: list, keys: np.ndarray, k: int) -> int:
    """The canonical kmers of all unitigs, taken together, are exactly
    the sorted key set, each once.  Returns the number of unitigs."""
    lens = np.array([len(s) for s in seqs], np.int64)
    if (lens < k).any():
        fail("a unitig is shorter than k")
    codes = CHAR_CODES[np.frombuffer(b"".join(seqs), np.uint8)]
    if (codes > 3).any():
        fail("a unitig holds a base other than ACGT")
    km = canonical_kmers_np(codes[None, :], k)
    offs = np.concatenate([[0], np.cumsum(lens)])
    inside = np.zeros(len(km), bool)
    nk = lens - k + 1
    starts = np.repeat(offs[:-1], nk) + (
        np.arange(nk.sum()) - np.repeat(np.cumsum(nk) - nk, nk))
    inside[starts] = True
    got = np.sort(km[inside])
    if len(got) != len(keys) or not np.array_equal(got, keys):
        fail(f"the unitigs' {len(got)} kmers are not the graph's "
             f"{len(keys)} kmers, each once")
    return len(seqs)


def check_edges_closed(keys: np.ndarray, edges: np.ndarray, k: int):
    """Every edge bit points at a kmer of the graph (k <= 31, 1 colour
    or the union of colours)."""
    ue = np.bitwise_or.reduce(edges, axis=1)
    mask = np.uint64((1 << (2 * k)) - 1)
    for o in (0, 1):
        okm = keys if o == 0 else revcomp_np(keys, k)
        for n in range(4):
            rows = np.nonzero((ue >> (n + 4 * o)) & 1)[0]
            nxt = ((okm[rows] << np.uint64(2)) | np.uint64(n)) & mask
            nkey = np.minimum(nxt, revcomp_np(nxt, k))
            pos = np.searchsorted(keys, nkey)
            if not (pos < len(keys)).all() or \
                    not np.array_equal(keys[pos], nkey):
                fail(f"an edge (orient {o}, base {n}) of the cleaned graph "
                     f"points at a kmer it does not hold")


def time_split(log: str) -> str:
    m = re.findall(r"time split: (.*)", log)
    return m[-1] if m else "missing"


def phase_graph_path(torch, tmp, card, raw, genome):
    """4b: clean and unitigs on the E. coli graph, through the CLI."""
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.ops.kernels import _build

    cln = os.path.join(tmp, "clean.ctx")
    fa = os.path.join(tmp, "unitigs.fa")
    walls, lookups = {}, 0
    for name, argv in (("clean", ["clean", "-T", "-U", "-o", cln, raw]),
                       ("unitigs", ["unitigs", "-o", fa, cln])):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        log = run_cli(argv + ["--device", "cuda"])
        walls[name] = time.perf_counter() - t0
        launched = dict(_build.LAUNCHES)
        print(f"launches in mctx-torch {name}: {json.dumps(launched)}")
        if launched.get("lookup", 0) <= 0:
            fail(f"mctx-torch {name} never launched the lookup kernel")
        lookups += launched["lookup"]
        print(f"graph path on {card}: mctx-torch {name} wall "
              f"{walls[name]:.3f}s; split: {time_split(log)}")
        if name == "clean":
            m = re.search(r"auto cleaning threshold: <(\d+)", log)
            if not m:
                fail("clean did not pick a coverage threshold")
            thresh = int(m.group(1))

    _h, rkeys, rcovg, _re = ctxio.read_ctx(raw)
    _h, ckeys, ccovg, cedges = ctxio.read_ctx(cln)
    rk, ck = rkeys[:, 0], ckeys[:, 0]
    pos = np.searchsorted(rk, ck)
    if not (pos < len(rk)).all() or not np.array_equal(rk[pos], ck):
        fail("the cleaned graph holds a kmer the raw graph does not")
    if not np.array_equal(rcovg[pos], ccovg):
        fail("cleaning changed the coverage of a kept kmer")
    if not len(ck) < len(rk):
        fail(f"clean kept all {len(rk)} kmers")
    check_edges_closed(ck, cedges, K_MAIN)
    nu = check_unitig_partition(read_fasta_seqs(fa), ck, K_MAIN)
    gk = np.unique(canonical_kmers_np(genome[None, :], K_MAIN))
    in_genome = int(np.isin(ck, gk).sum())
    print(f"graph path: threshold <{thresh}; {len(rk)} -> {len(ck)} kmers, "
          f"{in_genome} genome kmers kept of {len(gk)}, "
          f"{len(ck) - in_genome} non-genome kmers kept; {nu} unitigs "
          f"partition the cleaned kmers exactly; every edge closed")
    return lookups


def phase_byte_identity(torch, tmp):
    rng = np.random.default_rng(2)
    genome, reads0, _ = genome_and_reads(200_000, 10.0, seed=3)
    alt = genome.copy()
    snp = rng.random(len(alt)) < 0.005
    alt[snp] = (alt[snp] + 1) % 4
    nreads = len(reads0)
    st = rng.integers(0, len(alt) - 150, nreads)
    reads1 = np.lib.stride_tricks.sliding_window_view(alt, 150)[st].copy()
    reads1[rng.random(reads1.shape) < 0.002] = 4
    fq0, fq1 = os.path.join(tmp, "c0.fq"), os.path.join(tmp, "c1.fq")
    write_fastq(fq0, reads0, rng.integers(2, 41, reads0.shape).astype(np.uint8))
    write_fastq(fq1, reads1)
    for k in (K_MAIN, 63):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = os.path.join(tmp, f"two_k{k}_{dev}.ctx")
            run_cli(["build", "-k", str(k), "-Q", "5", "-H", "8",
                     "--sample", "a", "--seq", fq0, "--sample", "b",
                     "--seq", fq1, outs[dev], "--device", dev])
        a = open(outs["cuda"], "rb").read()
        b = open(outs["cpu"], "rb").read()
        if a != b:
            fail(f"k={k}: the CUDA and CPU .ctx files differ")
        print(f"byte identity k={k}: 2-colour .ctx of {len(a)} bytes, "
              f"CUDA == CPU")
        if k != K_MAIN:
            continue
        for engine in ("mp", "bitonic"):
            for dev in ("cuda", "cpu"):
                path = os.path.join(tmp, f"two_{engine}_{dev}.ctx")
                build_under(engine, [
                    "build", "-k", str(k), "-Q", "5", "-H", "8", "--sample",
                    "a", "--seq", fq0, "--sample", "b", "--seq", fq1, path,
                    "--device", dev],
                    required=ENGINE_KERNELS[engine] if dev == "cuda" else ())
                if open(path, "rb").read() != a:
                    fail(f"k={k} under {engine} on {dev}: the .ctx differs "
                         f"from the lax one")
            print(f"byte identity k={k} under MCTX_SORT={engine}: CUDA == CPU "
                  f"== the lax .ctx")
    # an existing graph's colours slotted in before a paired colour with -p
    raw = os.path.join(tmp, f"two_k{K_MAIN}_cuda.ctx")
    got = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"graph_pairs_{dev}.ctx")
        log = run_cli(["build", "-k", str(K_MAIN), "-p", "--graph", raw,
                       "--sample", "c", "--seq2", fq0, fq1, path, "--device",
                       dev])
        got[dev] = (open(path, "rb").read(),
                    re.search(r"removed (\d+) PCR duplicate reads", log))
    if got["cuda"][0] != got["cpu"][0] or not got["cuda"][1] or \
            got["cuda"][1].group(1) != got["cpu"][1].group(1):
        fail("--graph + --seq2 -p: the CUDA and CPU builds differ")
    print(f"byte identity --graph + --seq2 -p (k={K_MAIN}): 3-colour .ctx of "
          f"{len(got['cpu'][0])} bytes, CUDA == CPU, "
          f"{got['cuda'][1].group(1)} reads removed on both")
    # clean and unitigs of the k=31 graph, on the card and on the CPU
    for name, argv, out in (
            ("clean -T -U", ["clean", "-T", "-U", "-o"], "c.ctx"),
            ("unitigs", ["unitigs", "-o"], "u.fa"),
            ("unitigs --gfa", ["unitigs", "--gfa", "-o"], "u.gfa")):
        got = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{dev}_{out}")
            src = os.path.join(tmp, f"{dev}_c.ctx") if out != "c.ctx" else raw
            t0 = time.perf_counter()
            run_cli(argv + [path, src, "--device", dev])
            got[dev] = (open(path, "rb").read(), time.perf_counter() - t0)
        if got["cuda"][0] != got["cpu"][0]:
            fail(f"{name}: the CUDA and CPU outputs differ")
        print(f"byte identity {name} (k={K_MAIN}): {len(got['cpu'][0])} "
              f"bytes, CUDA == CPU (wall {got['cuda'][1]:.3f}s on the card, "
              f"{got['cpu'][1]:.3f}s on the CPU)")


def main():
    if not os.path.isdir(os.path.join(HERE, "mccortex_tpu_torch")):
        fail("mccortex_tpu_torch/ is not beside this script: run it from "
             "the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from mccortex_tpu_torch.ops.kernels import _build

    # 1. probe
    print(f"torch {torch.__version__}")
    print(f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)

    # 2. build the kernels
    secs = _build.build()
    print(f"built kernels {', '.join(_build.KERNELS)} in {secs:.1f}s")
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    results = {}
    shapes = phase_kernels(torch, results)
    sorts = phase_sorts(torch, results, shapes)
    del shapes
    torch.cuda.empty_cache()
    phase_lookup(torch, results)

    with tempfile.TemporaryDirectory() as tmp:
        # 4. the build path at real size, under every sort engine
        by_engine, genome, reads, raw = phase_main_path(torch, tmp, card)
        phase_paired(torch, tmp, card, genome, reads)
        del reads
        # 4b. clean and unitigs on its graph
        lookups = phase_graph_path(torch, tmp, card, raw, genome)
        # 5. CUDA and CPU outputs byte for byte
        phase_byte_identity(torch, tmp)

    # launches on the main path: the build's kernels from the E. coli build
    # under the default engine, the sort kernels from the build under the
    # engine that runs them, the lookup kernel from clean + unitigs
    launches = {"frontend": by_engine["lax"]["frontend"],
                "segreduce": by_engine["lax"]["segreduce"],
                "mergepath": by_engine["lax"]["mergepath"],
                "lookup": lookups,
                "mergelevel": by_engine["mp"]["mergelevel"],
                "bitonic_blocksort": by_engine["mp"]["bitonic_blocksort"],
                "bitonic_tail": by_engine["bitonic"]["bitonic_tail"],
                "bitonic_butterfly": by_engine["bitonic"]["bitonic_butterfly"]}
    sources = {"mergelevel": "mergepath", "bitonic_blocksort": "bitonic",
               "bitonic_tail": "bitonic", "bitonic_butterfly": "bitonic"}
    replaces = {
        "frontend": "mccortex_tpu/ops/pallas/frontend.py:203",
        "segreduce": "mccortex_tpu/ops/pallas/segreduce.py:321",
        "mergepath": "mccortex_tpu/ops/pallas/mergepath.py:262",
        "lookup": "mccortex_tpu/ops/pallas/lookup.py:163",
        "mergelevel": "mccortex_tpu/ops/pallas/mergepath.py:190",
        "bitonic_blocksort": "mccortex_tpu/ops/pallas/bitonic.py:106",
        "bitonic_tail": "mccortex_tpu/ops/pallas/bitonic.py:141",
        "bitonic_butterfly": "mccortex_tpu/ops/pallas/bitonic.py:186"}
    kernels = []
    for name in replaces:
        if launches[name] <= 0:
            fail(f"the main path never launched the {name} kernel")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"mccortex_tpu_torch/csrc/{sources.get(name, name)}.cu",
            replaces=replaces[name], launches=launches[name],
            **results[name]))
    print(card)
    print(json.dumps({"sorts": sorts}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the build epoch's kernels (front-end, segreduce) of one checkout of
the port on the card, and count the device operations of one epoch.

    python scripts/time_build_kernels.py [--root CHECKOUT] [--reps N]

Builds the two kernels of CHECKOUT (default: the checkout this script is
in), checks each timed call against its plain version (exact), and prints
one JSON line: CUDA-event times in ms of the front-end at an epoch's
batch (2048 reads of 150 bp, k=31 and k=63; records_fused on every
checkout, records_epoch where the checkout has it), of segreduce at an
epoch's shape (the sorted k=31 records of that batch: 245,760 records, 2
key planes and the edge plane, count kept) and at an LSM merge's shape
(8,388,608 records, 2 key planes, 1 coverage and 1 edge plane, with a
planted run of 100,000 equal keys and a sentinel tail; the call the
build makes there: the count dropped where the checkout can drop it,
else the reference's tuple and the concatenation the build made of it),
the device time of one segreduce call at each shape under torch.profiler
(all its operations, and its longest kernel alone), and the device
operations (kernels, memsets, copies) of one build epoch under the lax
engine, from torch.profiler.  It calls only functions that
every version of the port since its first has, or skips what a checkout
lacks, so two checkouts can be compared in one call on one card: run it
for each in turn (parent, change, change, parent).  Data is random, from
a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def time_ms(torch, fn, reps):
    """Mean device time of fn() over reps calls, the stream held by a
    sleep kernel while the host queues them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def epoch_batch(rng, B=2048, L=150):
    """A read batch: N bases at 0.5 %, half the reads shorter."""
    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.005] = 4
    lens = rng.integers(20, L + 1, size=B)
    lens[: B // 2] = L
    bases[np.arange(L)[None, :] >= lens[:, None]] = 4
    return bases


def merge_records(rng, M):
    """(2, M) sorted key planes with duplicates, a run of 100,000 equal
    keys and a 10 % sentinel tail; (1, M) coverage; (1, M) edges."""
    pool = np.unique(rng.integers(0, 1 << 62, size=M // 2, dtype=np.uint64))
    kv = np.sort(np.concatenate([
        pool[rng.integers(0, len(pool), M - 100_000 - M // 10)],
        np.full(100_000, pool[len(pool) // 2], np.uint64)]))
    kv = np.concatenate([kv, np.full(M // 10, np.uint64(2**64 - 1))])
    keys = np.stack([(kv >> np.uint64(32)).astype(np.uint32),
                     kv.astype(np.uint32)]).view(np.int32)
    covg = rng.integers(1, 100, (1, M)).astype(np.int32)
    edges = rng.integers(0, 256, (1, M)).astype(np.int32)
    return keys, covg, edges


def profiled(torch, fn, reps=1):
    """The device events of reps calls of fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ops(torch, fn):
    """Device operations of one fn() under torch.profiler, by kind; None
    when the profiler saw no device activity."""
    kinds = {"kernel": 0, "memset": 0, "memcpy": 0}
    for e in profiled(torch, fn):
        name = e.name.lower()
        kinds["memset" if "memset" in name else
              "memcpy" if "memcpy" in name else "kernel"] += 1
    return kinds if sum(kinds.values()) else None


def device_ms(torch, fn, reps):
    """Device ms of one fn() under torch.profiler: all its operations, and
    its longest kernel alone; None when the profiler saw no device
    activity."""
    by_name = {}
    for e in profiled(torch, fn, reps):
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    if not by_name:
        return None
    return {"all": sum(by_name.values()) / reps / 1e3,
            "longest_kernel": max(by_name.values()) / reps / 1e3}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_build_kernels: needs a CUDA device")
    from mccortex_tpu_torch.graph import build as gbuild
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import _build, frontend, segreduce

    _build.build(("frontend", "segreduce", "mergepath"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"root": os.path.abspath(args.root), "card": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()}

    def same(label, got, want):
        torch.cuda.synchronize()
        if not all(torch.equal(g.long(), w.long()) for g, w in zip(got, want)):
            sys.exit(f"time_build_kernels: {label}: kernel != plain")

    bases = torch.from_numpy(epoch_batch(rng)).to(dev)
    has_epoch = hasattr(frontend, "records_epoch")
    for k in (31, 63):
        same(f"records_fused k={k}", frontend.records_fused(bases, k),
             frontend.records_plain(bases, k))
        out[f"records_fused_k{k}"] = time_ms(
            torch, lambda: frontend.records_fused(bases, k), args.reps)
        if has_epoch:
            same(f"records_epoch k={k}", [frontend.records_epoch(bases, k)],
                 [frontend.records_epoch_plain(bases, k)])
            out[f"records_epoch_k{k}"] = time_ms(
                torch, lambda: frontend.records_epoch(bases, k), args.reps)

    # segreduce at the epoch's shape: the batch's sorted k=31 records
    Lv = bases.shape[1] - 31 + 1
    planes = torch.stack(frontend.records_fused(bases, 31))
    planes = planes[:, :, :Lv].reshape(3, -1).contiguous()
    planes = planes[:, sops.argsort_planes(planes[:2])].contiguous()
    keys, ors = planes[:2], planes[2:]
    same("segreduce epoch", segreduce.segreduce_compact_multi(keys, None, ors),
         segreduce.segreduce_plain(keys, keys[:0], ors))
    out["segreduce_epoch"] = time_ms(
        torch, lambda: segreduce.segreduce_compact_multi(keys, None, ors),
        args.reps)
    out["segreduce_epoch_device"] = device_ms(
        torch, lambda: segreduce.segreduce_compact_multi(keys, None, ors),
        args.reps)

    # segreduce at the merge's shape, as the build calls it there
    kp, cp, ep = merge_records(rng, 1 << 23)
    keys = torch.from_numpy(kp).to(dev)
    covg = torch.from_numpy(cp).to(dev)
    edges = torch.from_numpy(ep).to(dev)
    same("segreduce merge", segreduce.segreduce_compact_multi(keys, covg,
                                                              edges),
         segreduce.segreduce_plain(keys, covg, edges))
    if hasattr(segreduce, "segreduce_planes"):
        def merge_call():
            return segreduce.segreduce_planes(keys, covg, edges, count=False)
    else:
        def merge_call():
            ok, _c, os_, oo, n = segreduce.segreduce_compact_multi(
                keys, covg, edges)
            return torch.cat([ok, os_, oo]), n
    out["segreduce_merge"] = time_ms(torch, merge_call, 20)
    out["segreduce_merge_device"] = device_ms(torch, merge_call, 20)
    out["segreduce_merge_tuple"] = time_ms(
        torch, lambda: segreduce.segreduce_compact_multi(keys, covg, edges),
        20)

    # device operations of one lax epoch of that batch
    out["epoch_device_ops"] = device_ops(
        torch, lambda: gbuild._epoch(bases, 31, "lax"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

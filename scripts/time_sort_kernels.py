#!/usr/bin/env python3
"""Time the sort kernels of one checkout of the port on the card.

    python scripts/time_sort_kernels.py [--root CHECKOUT] [--reps N]

Builds the kernels of CHECKOUT (default: the checkout this script is in),
checks each timed call against its plain version (exact), and prints one
JSON line of CUDA-event times in ms: the merge level, the tail, the
butterfly and the tile sort at an epoch's shape (k=31: 245,760 records of
3 planes, 2 key planes; k=63: 180,224 records of 5 planes, 4 key planes),
merge path and one merge level at an LSM merge's shape (2 x 4,194,304
records of 4 planes), and the whole sorts of an epoch (sort_planes_mp,
bitonic sort_planes).  Apart from the sweep over the size of a fused
group of merge levels, which it skips where a checkout has none, it calls
only functions that every version of the port since the sort engines has,
so two checkouts can be compared in one call on one card: run it for each
in turn (parent, change, change, parent).  Data is random, from a seed.
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


def records(rng, M, np_, nk, bits=32):
    keys = rng.integers(0, 1 << bits, size=(nk, M), dtype=np.uint64).astype(
        np.uint32)
    vals = rng.integers(0, 256, size=(np_ - nk, M)).astype(np.uint32)
    return np.concatenate([keys, vals]).view(np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_sort_kernels: needs a CUDA device")
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import _build, bitonic, mergepath

    _build.build(("mergepath", "bitonic"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = bitonic.TILE
    out = {"root": os.path.abspath(args.root), "card": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()}

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            sys.exit(f"time_sort_kernels: {label}: kernel != plain")

    for label, M, np_, nk in (("k31", 245_760, 3, 2), ("k63", 180_224, 5, 4)):
        x = torch.from_numpy(records(rng, M, np_, nk)).to(dev)
        runs = bitonic.block_sort(x, nk, True)
        same(f"blocksort {label}", runs,
             bitonic.block_sort_plain(x, nk, True, T))
        alt = bitonic.block_sort(x, nk, False)
        bf = bitonic.butterfly(alt.clone(), nk, T, 2 * T, False)
        same(f"tail {label}", bitonic.tail(bf, nk, 2 * T, False),
             bitonic.tail_plain(bf, nk, 2 * T, False, T))
        same(f"mergelevel {label}", mergepath.merge_level(runs, nk, T),
             mergepath.merge_level_plain(runs, nk, T))
        want = x[:, sops.argsort_planes(x[:nk])]
        same(f"sort_planes_mp {label}", mergepath.sort_planes_mp(x, nk), want)
        xp = bitonic.pad_planes(x, nk, bitonic.padded_length(M))
        same(f"sort_planes {label}", bitonic.sort_planes(xp, nk)[:nk, :M],
             want[:nk])
        out[f"blocksort_{label}"] = time_ms(
            torch, lambda: bitonic.block_sort(x, nk, True), args.reps)
        out[f"mergelevel_{label}"] = time_ms(
            torch, lambda: mergepath.merge_level(runs, nk, T), args.reps)
        out[f"tail_{label}"] = time_ms(
            torch, lambda: bitonic.tail(bf, nk, 2 * T, False), args.reps)
        out[f"butterfly_{label}"] = time_ms(
            torch, lambda: bitonic.butterfly(alt.clone(), nk, T, 2 * T,
                                             False), args.reps) \
            - time_ms(torch, alt.clone, args.reps)
        # few enough calls that every launch queues behind the sleep kernel
        out[f"sort_planes_mp_{label}"] = time_ms(
            torch, lambda: mergepath.sort_planes_mp(x, nk), 10)
        out[f"bitonic_sort_planes_{label}"] = time_ms(
            torch, lambda: bitonic.sort_planes(xp, nk), 10)
        if hasattr(mergepath, "FUSE_RECORDS"):
            # the whole sort by the most records of a fused group of levels
            # (0: every level by the kernel that merges a pair's tiles), and
            # the first levels alone, fused into one launch
            saved = mergepath.FUSE_RECORDS
            for cap in (0, 2 * T, 4 * T, 8 * T):
                mergepath.FUSE_RECORDS = cap
                same(f"sort_planes_mp {label} cap {cap}",
                     mergepath.sort_planes_mp(x, nk), want)
                out[f"sort_planes_mp_{label}_cap{cap}"] = time_ms(
                    torch, lambda: mergepath.sort_planes_mp(x, nk), 10)
                L = mergepath.fused_levels(np_, T, 7)
                if L:
                    out[f"fused_{L}_levels_{label}_cap{cap}"] = time_ms(
                        torch, lambda: mergepath.merge_levels(runs, nk, T, L),
                        args.reps)
            mergepath.FUSE_RECORDS = saved

    Mh = 1 << 22
    a, b = (torch.from_numpy(records(rng, Mh, 4, 2, bits=20)).to(dev)
            for _ in range(2))
    a = a[:, sops.argsort_planes(a[:2])].contiguous()
    b = b[:, sops.argsort_planes(b[:2])].contiguous()
    both = torch.cat([a, b], dim=1)
    want = mergepath.merge_plain(a, b, 2)
    same("mergepath LSM", mergepath.merge_path_planes(a, b, 2), want)
    same("mergelevel LSM", mergepath.merge_level(both, 2, Mh), want)
    flipped = torch.cat([a, b.flip(1)], dim=1)
    same("tail LSM", bitonic.tail(flipped, 2, 2 * Mh, True),
         bitonic.tail_plain(flipped, 2, 2 * Mh, True, T))
    out["mergepath_lsm"] = time_ms(
        torch, lambda: mergepath.merge_path_planes(a, b, 2), 20)
    out["mergelevel_lsm"] = time_ms(
        torch, lambda: mergepath.merge_level(both, 2, Mh), 20)
    out["tail_lsm"] = time_ms(
        torch, lambda: bitonic.tail(flipped, 2, 2 * Mh, True), 20)
    out["bitonic_merge_planes_lsm"] = time_ms(
        torch, lambda: bitonic.merge_planes(a, b, 2), 5)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

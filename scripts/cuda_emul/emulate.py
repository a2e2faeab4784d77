#!/usr/bin/env python3
"""Run CUDA kernels of mccortex_tpu_torch/csrc on the CPU, for their logic.

    python scripts/cuda_emul/emulate.py [lookup] [table] [bitonic] [tail]
                                        [mergepath] [frontend] [segreduce]
                                        [walk]

A machine without nvcc or a GPU cannot compile or run a .cu.  This
rewrites a source for g++ (the CUDA runtime header becomes cuda_emul.h,
`kernel<<<grid, block, ...>>>(args)` becomes `emu::launch(grid, block,
...)`, the cp.async statements become plain copies), builds it as a
shared library with the same C entry points, calls those on numpy arrays
and holds the results against the plain PyTorch versions: the lookup
kernel on both row widths with forced chains, the table build through
ops/kernels/lookup.py's own launcher against the numpy build_table32 byte
for byte (tests/table_cases.py: W = 1 to 4, no key, one key, ragged sizes,
chains that wrap past the last row, rows past the register sort, a table
without an empty slot; as written and with the buckets' order reversed),
the tile sort at 1 to 9
key planes with ragged tiles and both direction rules, the tail on both
spans with equal keys, the merge path and the merge levels (one a launch
and fused) with ragged runs, heavy ties and windows at every alignment,
the front-end at k from 3 to 63 on rows shorter than k, ragged and long,
with N at the first, the last and inner bases, writing every window or
an epoch's, and the segreduce with runs that cross tiles, tiles without
a start, sentinel-only input, wrapping sums, key planes held and not
held in registers, the count plane dropped, and status words left by
earlier calls, and the linked walk kernel through links/walk.py's own
wrapper on the walks of tests/walk_cases.py (gap filling with and
without links, dropped pickups, cycles, both halts, k = 31 and 63), every
field of the state against the host loop's.  It proves nothing about what nvcc accepts, nor about
speed, and since blocks run in order it cannot show a look-back that
waits on a later block.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from mccortex_tpu_torch.constants import nwords  # noqa: E402
from mccortex_tpu_torch.ops.kernels import (  # noqa: E402
    bitonic, frontend, lookup, mergepath, segreduce)

CSRC = os.path.join(ROOT, "mccortex_tpu_torch", "csrc")


def _matching(src: str, start: int, open_ch: str, close_ch: str,
              step: int) -> int:
    """Index of the bracket that matches the one at `start`."""
    depth, i = 0, start
    while True:
        if src[i] == open_ch:
            depth += 1
        elif src[i] == close_ch:
            depth -= 1
            if depth == 0:
                return i
        i += step


def rewrite(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emul.h"')
    src = re.sub(r"extern __shared__ (__align__\(16\) )?uint32_t smem\[\];",
                 "uint32_t* smem = emu::dynamic_shared;", src)
    src = re.sub(r"const unsigned s = \(unsigned\)"
                 r"__cvta_generic_to_shared\(dst\);\n", "", src)
    src = re.sub(r'asm volatile\("cp\.async\.cg[^;]*;"[^;]*;',
                 "emu_copy16(dst, src);", src)
    src = re.sub(r'asm volatile\("cp\.async\.ca[^;]*;"[^;]*;',
                 "*dst = *src;", src)
    src = re.sub(r'asm volatile\("cp\.async\.(commit|wait)[^;]*;"[^;]*;', "",
                 src)
    src = re.sub(r'asm volatile\("ld\.volatile\.global\.v4\.u32[^;]*;"[^;]*;',
                 "v = *p;", src)
    src = re.sub(r'asm volatile\("st\.volatile\.global\.v4\.u32[^;]*;"[^;]*;',
                 "*p = v;", src)
    if "asm" in src:
        raise ValueError("an asm statement that rewrite() does not know")
    out, pos = [], 0
    while (i := src.find("<<<", pos)) >= 0:
        j = i                               # the kernel's name, with <...>
        if src[j - 1] == ">":
            j = _matching(src, j - 1, ">", "<", -1)
        while src[j - 1].isalnum() or src[j - 1] == "_":
            j -= 1
        k = src.find(">>>", i)
        cfg = [c.strip() for c in src[i + 3:k].split(",")]
        e = _matching(src, k + 3, "(", ")", 1)
        out += [src[pos:j], f"emu::launch({cfg[0]}, {cfg[1]}, [=] {{ "
                            f"{src[j:i]}({src[k + 4:e]}); }})"]
        pos = e + 1
    out.append(src[pos:])
    return "".join(out)


def build(name: str, tmp: str, nptr: int, nint: int, symbol: str,
          patch: tuple = (), tag: str = ""):
    """The C entry point `symbol` of csrc/<name>.cu built for the CPU;
    `patch` (old, new) replaces text of the source first (a variant,
    built apart under `tag`)."""
    cpp = os.path.join(tmp, f"{name}{tag}.cpp")
    so = os.path.join(tmp, f"lib{name}{tag}.so")
    if not os.path.exists(so):
        with open(os.path.join(CSRC, f"{name}.cu")) as fh, \
                open(cpp, "w") as out:
            src = fh.read()
            if patch:
                if patch[0] not in src:
                    raise ValueError(f"{name}.cu: no {patch[0]!r} to patch")
                src = src.replace(*patch)
            out.write(rewrite(src))
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", HERE, "-o", so, cpp], check=True)
    fn = getattr(ctypes.CDLL(so), symbol)
    fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_lookup(tmp: str) -> None:
    fn = build("lookup", tmp, 4, 4, "mctx_lookup")
    rng = np.random.default_rng(0)
    sent = np.uint64(2**64 - 1)
    for W, n, Q, b_bits, R in [
            (1, 3000, 1000, None, 32), (1, 3000, 77, None, 128),
            (2, 2000, 515, None, 32), (2, 2000, 300, None, 128),
            (1, 2500, 900, 8, 32), (3, 1000, 301, 8, 32),
            (4, 700, 257, 8, 32), (1, 20, 100, 1, 32), (1, 500, 1, None, 32),
            (3, 500, 33, None, 128), (4, 500, 65, None, 128)]:
        keys = np.unique(rng.integers(0, 1 << 62, size=(n, W),
                                      dtype=np.uint64), axis=0)
        make = lookup.build_table32 if R == 32 else lookup.build_table128
        table, bb = make(keys, b_bits=b_bits)
        q = keys[rng.integers(0, len(keys), Q)]
        absent = rng.random(Q) < 0.4
        q[absent] = rng.integers(0, 1 << 62, size=(int(absent.sum()), W),
                                 dtype=np.uint64)
        q[rng.random(Q) < 0.05] = sent
        idx = np.full(Q, -7, np.int32)
        found = np.full(Q, 9, np.uint8)
        rc = fn(q.ctypes.data, table.ctypes.data, idx.ctypes.data,
                found.ctypes.data, Q, W, bb, R, None)
        tt, qt = (torch.from_numpy(table.view(np.int32)),
                  torch.from_numpy(q.view(np.int64)))
        want = lookup.lookup_plain(tt, qt, bb, W)
        ok = rc == 0 and np.array_equal(idx, want[0].numpy()) and \
            np.array_equal(found.astype(bool), want[1].numpy())
        print(f"lookup W={W} n={n} Q={Q} rows of {R} words, 2^{bb} rows: "
              f"{'exact' if ok else 'MISMATCH'}; most rows read "
              f"{int(lookup.rows_read(tt, qt, bb, W).max())}", flush=True)
        if not ok:
            sys.exit(1)


# Blocks run in order here and a block's threads nearly so, so the
# histogram's atomic adds hand out ranks in store-row order and every
# bucket comes out sorted already.  This variant counts the keys from the
# last to the first, so that the buckets come out reversed and the sorts
# and the sorted tails a row passes on are put to work, as the card's
# arbitrary order of atomics does.
REVERSED = ("const int i = blockIdx.x * kThreads + threadIdx.x;\n"
            "  if (i >= n) return;\n  const uint64_t* key",
            "const int i = n - 1 - (int)(blockIdx.x * kThreads + "
            "threadIdx.x);\n  if (i < 0) return;\n  const uint64_t* key")


def table_fns(tmp: str, reversed_ranks: bool = False) -> dict:
    """The table build's two C entry points of csrc/lookup.cu, built for
    the CPU, by symbol; `reversed_ranks`: the REVERSED variant."""
    patch, tag = (REVERSED, "_rev") if reversed_ranks else ((), "")
    return {"mctx_table32": build("lookup", tmp, 10, 3, "mctx_table32",
                                  patch, tag),
            "mctx_table32_round": build("lookup", tmp, 6, 3,
                                        "mctx_table32_round", patch, tag)}


def table_on_cpu(fns: dict, keys: np.ndarray, b_bits):
    """lookup._table32_launch as it is, its launches the kernels compiled
    for the CPU: (table as uint32, b_bits, rounds)."""
    from mccortex_tpu_torch.ops.kernels import _build
    saved = _build.function, _build.stream_of
    _build.function = lambda name, symbol, *a: fns[symbol]
    _build.stream_of = lambda t: None
    try:
        table, bb, rounds = lookup._table32_launch(
            torch.from_numpy(keys.view(np.int64)), b_bits)
    finally:
        _build.function, _build.stream_of = saved
    return table.numpy().view(np.uint32), bb, rounds


def check_table(tmp: str) -> None:
    import table_cases as tc
    for variant in ("", " (ranks reversed)"):
        fns = table_fns(tmp, bool(variant))
        for label, (W, n, b_bits, extra) in tc.CASES.items():
            keys = tc.keys_of(W, n, b_bits, extra)
            want, wb = lookup.build_table32(keys, b_bits=b_bits)
            got, gb, rounds = table_on_cpu(fns, keys, b_bits)
            ok = gb == wb and np.array_equal(got, want) and \
                rounds == tc.rounds_of(want, keys, wb)
            print(f"table{variant} {label}: {len(keys)} keys, 2^{wb} rows, "
                  f"{rounds} rounds: {'exact' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                sys.exit(1)


def check_bitonic(tmp: str) -> None:
    fn = build("bitonic", tmp, 2, 6, "mctx_bitonic_blocksort")
    T = bitonic.TILE
    for M, nk, np_, hi, all_asc in [
            (T, 2, 3, 2**32, 1), (3 * T + 17, 2, 3, 4, 1), (2 * T, 2, 3, 3, 0),
            (T - 1, 1, 1, 5, 1), (1, 1, 2, 5, 1), (T + 1, 3, 3, 2**32, 1),
            (2 * T, 4, 5, 2, 0), (T + 5, 4, 5, 2**32, 1), (4 * T, 1, 2, 7, 0),
            (T, 5, 9, 4, 1), (2 * T, 9, 11, 2, 0), (T, 2, 3, 1, 1)]:
        rng = np.random.default_rng(M + nk)
        keys = rng.integers(0, hi, size=(nk, M), dtype=np.uint64).astype(
            np.uint32)
        keys[:, rng.random(M) < 0.1] = 0xFFFFFFFF
        vals = rng.integers(0, 2**32, size=(np_ - nk, M), dtype=np.uint64
                            ).astype(np.uint32)
        x = np.ascontiguousarray(np.concatenate([keys, vals]).view(np.int32))
        out = np.full_like(x, 12345)
        rc = fn(x.ctypes.data, out.ctypes.data, M, nk, np_, M, M, all_asc,
                None)
        want = bitonic.block_sort_plain(torch.from_numpy(x), nk,
                                        bool(all_asc), T).numpy()
        ok = rc == 0 and np.array_equal(out, want)
        print(f"blocksort M={M} nk={nk} np={np_} keys below {hi} "
              f"all_asc={all_asc}: {'exact' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            sys.exit(1)


def _records(rng, M, nk, np_, hi, ld=None, sent=0.1):
    """(np_, ld) int32 records of which the first M columns are live: nk
    key planes below hi with a share of all-ones keys, random payload."""
    ld = ld or M
    keys = rng.integers(0, hi, size=(nk, ld), dtype=np.uint64).astype(
        np.uint32)
    keys[:, rng.random(ld) < sent] = 0xFFFFFFFF
    vals = rng.integers(0, 2**32, size=(np_ - nk, ld), dtype=np.uint64
                        ).astype(np.uint32)
    return np.ascontiguousarray(np.concatenate([keys, vals]).view(np.int32))


def _sort_runs(x, M, nk, R):
    for s in range(0, M, R):
        run = torch.from_numpy(x[:, s:min(s + R, M)])
        order = mergepath.sops.argsort_planes(run[:nk]).numpy()
        x[:, s:min(s + R, M)] = run.numpy()[:, order]


def check_tail(tmp: str) -> None:
    fn = build("bitonic", tmp, 2, 8, "mctx_bitonic_tail")
    T = bitonic.TILE
    for span, nspans, nk, np_, hi, k, final_asc, ld in [
            (T, 4, 2, 3, 2**32, 2 * T, 0, None), (T, 2, 1, 1, 5, 4 * T, 1, None),
            (T, 1, 2, 3, 1, 2 * T, 0, None), (T, 4, 4, 5, 2, 2 * T, 0, None),
            (T, 1, 3, 14, 2**32, T, 1, T + 3), (2 * T, 2, 2, 3, 3, 2 * T, 0, None),
            (2 * T, 1, 4, 6, 2**32, 4 * T, 1, 2 * T + 1),
            (2 * T, 1, 1, 2, 1, 2 * T, 0, None), (T, 4, 5, 6, 2, 2 * T, 0, None),
            (2 * T, 2, 3, 4, 2, 2 * T, 0, None),
            (T, 1, 9, 10, 2, 2 * T, 1, None)]:
        M = span * nspans
        rng = np.random.default_rng(M + nk + np_)
        x = _records(rng, M, nk, np_, hi, ld, sent=0.0 if hi == 1 else 0.1)
        ld = x.shape[1]
        out = np.full_like(x, 12345)
        rc = fn(x.ctypes.data, out.ctypes.data, M, nk, np_, ld, ld,
                k.bit_length() - 1, final_asc, span, None)
        want = bitonic.tail_plain(torch.from_numpy(x[:, :M].copy()), nk, k,
                                  bool(final_asc), span).numpy()
        ok = rc == 0 and np.array_equal(out[:, :M], want)
        print(f"tail span={span} M={M} nk={nk} np={np_} keys below {hi} k={k} "
              f"final_asc={final_asc} ld={ld}: "
              f"{'exact' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            sys.exit(1)


def check_mergepath(tmp: str) -> None:
    level = build("mergepath", tmp, 2, 8, "mctx_mergelevel")
    for M, R, nk, np_, hi, levels, fused, ld in [
            (3000, 1000, 2, 3, 2**32, 1, 0, None),   # ld % 4 == 0, any window
            (3001, 1024, 2, 3, 4, 1, 0, None),       # ld % 4 != 0
            (3001, 1024, 2, 3, 4, 1, 0, 3004),
            (2500, 2048, 1, 1, 3, 1, 0, None), (700, 300, 3, 4, 2, 1, 0, None),
            (5000, 777, 4, 5, 2, 1, 0, 5000), (40, 1, 2, 3, 2, 1, 0, None),
            (1500, 1 << 20, 2, 3, 5, 1, 0, None), (2100, 512, 5, 6, 2, 1, 0, 2100),
            (2100, 700, 9, 18, 2, 1, 0, 2100), (1030, 515, 2, 20, 9, 1, 0, 1032),
            (2048, 1024, 2, 3, 1, 1, 0, None),
            (4096, 1024, 2, 3, 2**32, 2, 1, None), (9000, 512, 2, 3, 3, 3, 1, None),
            (5001, 1, 1, 2, 4, 12, 1, None), (4097, 777, 4, 5, 2, 2, 1, 4100),
            (3000, 100, 3, 3, 2, 1, 1, None), (20000, 2048, 2, 3, 7, 3, 1, None),
            (3000, 256, 9, 10, 2, 4, 1, None), (100, 64, 2, 3, 2, 5, 1, None)]:
        rng = np.random.default_rng(M + R + nk)
        x = _records(rng, M, nk, np_, hi, ld, sent=0.0 if hi == 1 else 0.1)
        ld = x.shape[1]
        _sort_runs(x, M, nk, R)
        out = np.full_like(x, 12345)
        rc = level(x.ctypes.data, out.ctypes.data, M, min(R, M), nk, np_, ld,
                   ld, levels, fused, None)
        want = mergepath.merge_levels_plain(
            torch.from_numpy(x[:, :M].copy()), nk, R, levels).numpy()
        ok = rc == 0 and np.array_equal(out[:, :M], want)
        print(f"mergelevel M={M} R={R} nk={nk} np={np_} keys below {hi} "
              f"levels={levels} fused={fused} ld={ld}: "
              f"{'exact' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            sys.exit(1)
    merge = build("mergepath", tmp, 4, 6, "mctx_mergepath")
    for Ma, Mb, nk, np_, hi, pad in [
            (3000, 2500, 2, 4, 2**32, 0), (1500, 10, 1, 3, 50, 2),
            (0, 1500, 2, 2, 2**32, 1), (1024, 1024, 4, 6, 3, 0),
            (700, 2001, 5, 7, 2, 3), (1200, 900, 2, 19, 5, 0)]:
        rng = np.random.default_rng(Ma + Mb + nk)
        a = _records(rng, Ma, nk, np_, hi, Ma + pad)
        b = _records(rng, Mb, nk, np_, hi, Mb + pad)
        _sort_runs(a, Ma, nk, max(Ma, 1))
        _sort_runs(b, Mb, nk, max(Mb, 1))
        out = np.full((np_, Ma + Mb), 12345, np.int32)
        split = np.zeros(-(-(Ma + Mb) // mergepath.TILE) + 1, np.int32)
        rc = merge(a.ctypes.data, b.ctypes.data, out.ctypes.data,
                   split.ctypes.data, Ma, Mb, nk, np_, a.shape[1], b.shape[1],
                   None)
        want = mergepath.merge_plain(torch.from_numpy(a[:, :Ma].copy()),
                                     torch.from_numpy(b[:, :Mb].copy()),
                                     nk).numpy()
        ok = rc == 0 and np.array_equal(out, want)
        print(f"mergepath Ma={Ma} Mb={Mb} nk={nk} np={np_} keys below {hi} "
              f"strides {a.shape[1]}, {b.shape[1]}: "
              f"{'exact' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            sys.exit(1)


def check_frontend(tmp: str) -> None:
    fn = build("frontend", tmp, 2, 4, "mctx_frontend")
    for k in (3, 11, 31, 32, 33, 63):
        for L in sorted({1, k - 1, k, 20, 150, 151, 3000}):
            B = 2 if L >= 3000 else 5
            rng = np.random.default_rng(k * 10000 + L)
            bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
            bases[rng.random((B, L)) < 0.02] = 4
            bases[0, 0] = 4                      # N at the first base
            bases[1, L - 1] = 7                  # and at the last
            bases[-1, L // 2] = 4                # and inside
            want_all = torch.stack(frontend.records_plain(
                torch.from_numpy(bases), k)).numpy()
            for lv in sorted({L, frontend.epoch_windows(L, k)}):
                out = np.full((2 * nwords(k) + 1, B * lv), 12345, np.int32)
                rc = fn(bases.ctypes.data, out.ctypes.data, B, L, lv, k, None)
                want = want_all[:, :, :lv].reshape(out.shape[0], -1)
                ok = rc == 0 and np.array_equal(out, want)
                print(f"frontend k={k} B={B} L={L} lv={lv}: "
                      f"{'exact' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    sys.exit(1)


def _sorted_planes(rng, M, nk, n_unique, sent_frac):
    """(nk, M) int32 key planes: n_unique random keys repeated, sorted
    unsigned-lexicographically, then a sentinel tail."""
    n_sent = int(M * sent_frac)
    pool = rng.integers(0, 2**32, size=(n_unique, nk), dtype=np.uint64)
    rows = pool[rng.integers(0, n_unique, M - n_sent)].astype(np.uint32)
    rows = rows[np.lexsort(rows.T[::-1])]
    rows = np.concatenate([rows, np.full((n_sent, nk), 0xFFFFFFFF,
                                         np.uint32)])
    return np.ascontiguousarray(rows.T).view(np.int32)


# Blocks run in order here, so every look-back would stop at the tile
# just before.  This variant never raises a tile's descriptor past its
# own aggregate (tile 0 alone is a prefix), so every look-back walks back
# to tile 0, over steps of 32 tiles.
WALK_BACK = ("st_desc(a.desc + tile, make_uint4((a.gen << 2) | kPrefix,",
             "if (0) st_desc(a.desc + tile, make_uint4((a.gen << 2) | kPrefix,")


def check_segreduce(tmp: str) -> None:
    fns = {"": build("segreduce", tmp, 7, 9, "mctx_segreduce"),
           " (look-back to tile 0)": build(
               "segreduce", tmp, 7, 9, "mctx_segreduce", WALK_BACK, "_walk")}
    T = segreduce.TILE
    desc = np.zeros((400, 4), np.uint32)
    desc[::3, 0] = (7 << 2) | 2           # an older call's words (gen 7)
    gen = 7
    for variant, label, M, nk, ns, no, count, n_unique, sent in [
            ("", "one record", 1, 2, 0, 1, 1, 1, 0.0),
            ("", "ragged tiles", 3 * T + 77, 2, 0, 1, 1, 900, 0.1),
            ("", "heavy duplicates", 4 * T + 5, 2, 1, 1, 0, 6, 0.0),
            ("", "run over five tiles", 6 * T, 1, 1, 1, 1, 0, 0.0),
            ("", "tiles without a start", 5 * T + 3, 2, 2, 2, 1, 2, 0.05),
            ("", "all sentinels", 2 * T + 9, 2, 1, 1, 1, 1, 1.0),
            ("", "four key planes, -1 planes", 3 * T, 4, 1, 0, 1, 400, 0.2),
            ("", "wrapping sums", 2 * T + 1, 1, 3, 0, 0, 3, 0.0),
            ("", "no value planes", 2 * T, 2, 0, 0, 0, 700, 0.3),
            ("", "keys only, count", 3 * T + 1, 3, 0, 0, 1, 1000, 0.0),
            ("", "six key planes", 3 * T + 17, 6, 1, 1, 0, 300, 0.1),
            ("", "five key planes, 33 planes", T + 31, 5, 20, 13, 1, 50, 0.1),
            ("w", "run over 260 tiles", 260 * T + 3, 2, 1, 1, 0, 0, 0.0),
            ("w", "random keys", 140 * T, 2, 1, 1, 1, 30000, 0.1),
            ("w", "three keys, 7 planes", 140 * T - 9, 1, 3, 3, 1, 3, 0.02)]:
        fn = fns[" (look-back to tile 0)" if variant else ""]
        rng = np.random.default_rng(M + nk + ns)
        if n_unique:
            keys = _sorted_planes(rng, M, nk, n_unique, sent)
        else:                        # one key over most of the tiles
            keys = _sorted_planes(rng, M, nk, M // 4, 0.0)
            keys[:, 500:M - 200] = keys[:, 500:501]
            keys = keys[:, np.lexsort(keys.view(np.uint32)[::-1])]
        if nk == 4:                  # live keys with -1 planes
            keys[:2, : M // 3] = -1
            keys = keys[:, np.lexsort(keys.view(np.uint32)[::-1])]
        lo, hi = (2**31 - 3, 2**31) if "wrap" in label else (-2**31, 2**31)
        sums = rng.integers(lo, hi, size=(ns, M)).astype(np.int32)
        ors = rng.integers(-2**31, 2**31, size=(no, M)).astype(np.int32)
        keys = np.ascontiguousarray(keys)
        nv = count + ns + no
        tiles = -(-M // T)
        out = np.full((nk + nv, M), 12345, np.int32)
        extra = np.full(max(1, tiles * 2 * max(nv - 2, 0)), 99, np.int32)
        n = np.full(1, -5, np.int32)
        gen += 1
        rc = fn(keys.ctypes.data, sums.ctypes.data if ns else None,
                ors.ctypes.data if no else None, out.ctypes.data,
                desc.ctypes.data, extra.ctypes.data, n.ctypes.data, nk,
                ns, no, count, M, M, M, M, gen, None)
        want, wn = segreduce.segreduce_planes_plain(
            torch.from_numpy(keys), torch.from_numpy(sums),
            torch.from_numpy(ors), bool(count))
        ok = rc == 0 and int(n[0]) == int(wn) and \
            np.array_equal(out, want.numpy())
        print(f"segreduce{' (look-back to tile 0)' if variant else ''} "
              f"{label}: M={M} nk={nk} ns={ns} no={no} "
              f"count={count}, n={int(wn)}: {'exact' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            sys.exit(1)


def check_walk(tmp: str) -> None:
    import walk_cases as wc
    from mccortex_tpu_torch.ops.kernels import _build
    fn = build("walk", tmp, 31, 13, "mctx_walk")
    # links/walk._walk_fused as it is, its launch on the CPU
    _build.function = lambda *a: fn
    _build.stream_of = lambda t: None
    torch.cuda.device = lambda d: contextlib.nullcontext()

    cases = [
        ("gap filling, no links, k=31",
         lambda: wc.gapfill_case(31, "cpu", with_links=False)),
        ("gap filling with links, k=31", lambda: wc.gapfill_case(31, "cpu")),
        ("gap filling with links, k=63",
         lambda: wc.gapfill_case(63, "cpu", rlen=150)),
        ("repeat, dropped pickups, k=31", lambda: wc.repeat_walks(31, "cpu")),
        ("repeat, colour None, k=63",
         lambda: wc.repeat_walks(63, "cpu", colour=None)),
        ("cycle with links, k=31", lambda: wc.cycle_walks(31, "cpu")),
        ("cycle, no links, k=63",
         lambda: wc.cycle_walks(63, "cpu", with_links=False)),
        ("max_len halt", lambda: wc.halt_walks(31, "cpu", 5, 50)),
        ("max_steps halt", lambda: wc.halt_walks(31, "cpu", 400, 7))]
    for label, make in cases:
        g, links, st, kw = make()
        want = wc.walk_both(g, links, st, kw, False)
        got = wc.walk_both(g, links, st, kw, True)
        # resumed from the state the first call left
        want2 = wc.walk_both(g, links, want, kw, False)
        got2 = wc.walk_both(g, links, want, kw, True)
        bad = wc.differing_fields(got, want) + wc.differing_fields(got2,
                                                                  want2)
        print(f"walk {label}: {st.cur_link.shape[0]} walkers, "
              f"{links.nlinks} links, halts "
              f"{np.bincount(want.base.status.numpy(), minlength=13)}, "
              f"{int(want.n_drop.sum())} drops: "
              f"{'exact' if not bad else 'MISMATCH ' + ', '.join(bad)}",
              flush=True)
        if bad:
            sys.exit(1)


def main() -> None:
    which = sys.argv[1:] or ["lookup", "table", "bitonic", "tail",
                             "mergepath", "frontend", "segreduce", "walk"]
    with tempfile.TemporaryDirectory() as tmp:
        if "lookup" in which:
            check_lookup(tmp)
        if "table" in which:
            check_table(tmp)
        if "bitonic" in which:
            check_bitonic(tmp)
        if "tail" in which:
            check_tail(tmp)
        if "mergepath" in which:
            check_mergepath(tmp)
        if "frontend" in which:
            check_frontend(tmp)
        if "segreduce" in which:
            check_segreduce(tmp)
        if "walk" in which:
            check_walk(tmp)
    print("ok")


if __name__ == "__main__":
    main()

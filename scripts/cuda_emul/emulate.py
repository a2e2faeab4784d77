#!/usr/bin/env python3
"""Run CUDA kernels of mccortex_tpu_torch/csrc on the CPU, for their logic.

    python scripts/cuda_emul/emulate.py [lookup] [bitonic] [tail] [mergepath]

A machine without nvcc or a GPU cannot compile or run a .cu.  This
rewrites a source for g++ (the CUDA runtime header becomes cuda_emul.h,
`kernel<<<grid, block, ...>>>(args)` becomes `emu::launch(grid, block,
...)`, the cp.async statements become plain copies), builds it as a
shared library with the same C entry points, calls those on numpy arrays
and holds the results against the plain PyTorch versions: the lookup
kernel on both row widths with forced chains, the tile sort at 1 to 9
key planes with ragged tiles and both direction rules, the tail on both
spans with equal keys, the merge path and the merge levels (one a launch
and fused) with ragged runs, heavy ties and windows at every alignment.
It proves nothing about what nvcc accepts, nor about speed.
"""

from __future__ import annotations

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

from mccortex_tpu_torch.ops.kernels import (  # noqa: E402
    bitonic, lookup, mergepath)

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


def build(name: str, tmp: str, nptr: int, nint: int, symbol: str):
    cpp, so = os.path.join(tmp, f"{name}.cpp"), os.path.join(tmp,
                                                             f"lib{name}.so")
    if not os.path.exists(so):
        with open(os.path.join(CSRC, f"{name}.cu")) as fh, \
                open(cpp, "w") as out:
            out.write(rewrite(fh.read()))
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


def main() -> None:
    which = sys.argv[1:] or ["lookup", "bitonic", "tail", "mergepath"]
    with tempfile.TemporaryDirectory() as tmp:
        if "lookup" in which:
            check_lookup(tmp)
        if "bitonic" in which:
            check_bitonic(tmp)
        if "tail" in which:
            check_tail(tmp)
        if "mergepath" in which:
            check_mergepath(tmp)
    print("ok")


if __name__ == "__main__":
    main()

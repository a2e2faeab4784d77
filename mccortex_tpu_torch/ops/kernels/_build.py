"""Kernel loader: nvcc into a shared library with a plain C interface,
loaded with ctypes.

At first use each `csrc/<name>.cu` is compiled for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into `_build/lib<name>.so`
inside the package (listed in .gitignore) and rebuilt when its source
is newer.  A build takes seconds because the sources include only the
CUDA runtime, never PyTorch's headers.

Every C entry point takes device pointers, ints and the CUDA stream
(`ctypes.c_void_p` for each pointer and the stream), launches on the
caller's stream, allocates nothing and returns `cudaGetLastError()`;
`check` raises on a non-zero code.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it.  A
source file may hold several kernels, each counted under its own name:
mergepath.cu holds `mergepath` and `mergelevel`, bitonic.cu holds
`bitonic_blocksort`, `bitonic_tail` and `bitonic_butterfly`.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("frontend", "segreduce", "mergepath", "lookup", "bitonic")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

LAUNCHES: collections.Counter = collections.Counter()
LOGS: dict = {}          # kernel name -> nvcc/ptxas output of its build

_libs: dict = {}
_fns: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit at first use")
    return path


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so, src = _so_path(name), os.path.join(CSRC_DIR, f"{name}.cu")
    return not os.path.exists(so) or \
        os.path.getmtime(so) < os.path.getmtime(src)


def build(names=KERNELS) -> float:
    """Compile the named kernels that are missing or stale, in parallel.
    Returns the seconds taken; raises RuntimeError with nvcc's output
    when a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = _so_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{out}")
            continue
        os.replace(tmp, _so_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, symbol: str, nargs_ptr: int, nargs_int: int):
    """The C entry point `symbol` of kernel `name`, built and loaded on
    first use.  Its arguments are `nargs_ptr` pointers, `nargs_int` ints
    and the stream, in that order."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = _libs[name] = ctypes.CDLL(_so_path(name))
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                           + [ctypes.c_int] * nargs_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
    return fn


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1

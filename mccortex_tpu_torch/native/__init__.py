"""The native (C++) sequence reader, loaded with ctypes.

`seqio.cpp` is compiled at first use with
`g++ -O3 -march=native -shared -fPIC seqio.cpp -o <tmp> -lz` into
`mccortex_tpu_torch/_build/libmctxio.so` (listed in .gitignore) and
rebuilt when the source is newer.  Each process compiles to a file of
its own and renames it into place, so processes that build at once
(test workers) never load a half-written library.  Without g++ or
zlib's headers the build fails, `get_lib()` returns None and the
readers of `io/seqio.py` parse in Python instead (the same batches,
slower); `io.seqio.reader_name()` says which reader runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "seqio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SO = os.path.join(BUILD_DIR, "libmctxio.so")

_lib = None
_tried = False
_lock = threading.Lock()
LOG = ""        # compiler output of the last build attempt


def _stale() -> bool:
    return not os.path.exists(SO) or \
        os.path.getmtime(SO) < os.path.getmtime(SRC)


def build() -> bool:
    """Compile the library if it is missing or older than its source.
    Returns True when a current library is in place."""
    global LOG
    if not _stale():
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", SRC,
           "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        LOG = str(e)
        print(f"[mctx native] build unavailable: {e}", file=sys.stderr)
        return False
    LOG = r.stdout + r.stderr
    if r.returncode != 0:
        print(f"[mctx native] build failed:\n{r.stderr}", file=sys.stderr)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, SO)
    return True


def get_lib():
    """The loaded library (built if needed), or None when it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(SO)
        except OSError as e:
            print(f"[mctx native] load failed: {e}", file=sys.stderr)
            return None
        lib.mctx_seq_open.restype = ctypes.c_void_p
        lib.mctx_seq_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_long]
        lib.mctx_seq_close.restype = None
        lib.mctx_seq_close.argtypes = [ctypes.c_void_p]
        for fn in (lib.mctx_seq_read_batch, lib.mctx_seq_read_records):
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib

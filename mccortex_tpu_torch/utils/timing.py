"""The port's tracer: wall-time spans of its phases and counts of its
work, for the commands' status lines and for torch.profiler.

`span(name, device)` adds the seconds of its body to SPANS[name]; on a
CUDA device it synchronises first and last, so a span holds the device
work queued inside it.  Spans nest: an outer span includes its inner
ones (the adjacency includes its table build).  While a torch profiler
runs, a span is also a FUNCTION-scope range of that name on the
profiler's host timeline (under `emit_nvtx`, an NVTX range), opened
after the first synchronisation and closed after the last, so every
kernel issued in it ends inside it.  A FUNCTION-scope range is not
mirrored onto the device's timeline, as a `record_function` range is.

`count(name, n)` adds n to COUNTERS[name].  `reset()` clears both at
the start of a command; `summary()` is the `time split:` status line.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

SPANS: collections.OrderedDict = collections.OrderedDict()
COUNTERS: collections.OrderedDict = collections.OrderedDict()


def reset() -> None:
    SPANS.clear()
    COUNTERS.clear()


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str, device="cpu"):
    _sync(device)
    rng = None
    if _profiler._is_profiler_enabled:
        rng = torch._C._profiler._RecordFunctionFast(name)
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        if rng is not None:
            rng.__exit__(None, None, None)
        SPANS[name] = SPANS.get(name, 0.0) + time.perf_counter() - t0


def summary() -> str:
    line = ", ".join(f"{k} {v:.3f}s" for k, v in SPANS.items())
    if COUNTERS:
        line += "; counts: " + ", ".join(f"{k} {v}"
                                         for k, v in COUNTERS.items())
    return line

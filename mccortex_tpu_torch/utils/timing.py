"""Wall-time spans of the graph phases, for the commands' status lines.

`span(name, device)` adds the seconds of its body to SPANS[name]; on a
CUDA device it synchronises first and last, so a span holds the device
work queued inside it.  Spans nest: an outer span includes its inner
ones (the adjacency includes its table build).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

SPANS: collections.OrderedDict = collections.OrderedDict()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str, device="cpu"):
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        SPANS[name] = SPANS.get(name, 0.0) + time.perf_counter() - t0


def summary() -> str:
    return ", ".join(f"{k} {v:.3f}s" for k, v in SPANS.items())

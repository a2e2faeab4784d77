"""Memory budgeting; copy of mccortex_tpu/utils/membudget.py (which cannot
be imported without jax), plus the device's own memory.

-m/--memory is a budget for the store: bytes per kmer = W*8 (key) +
ncols*4 (covg) + ncols (edges).  Commands print their plan and fail fast
when it cannot fit the budget or the device's memory.
"""

from __future__ import annotations

import re


def parse_mem(s: str) -> int:
    """'8G', '500M', '4GB', '1024' (bytes) -> bytes
    (ref cmd_mem_args_set_memory / mem_to_integer)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([kKmMgGtT]?)B?\s*", s)
    if not m:
        raise ValueError(f"bad memory size: {s!r}")
    val = float(m.group(1))
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20,
            "g": 1 << 30, "t": 1 << 40}[m.group(2).lower()]
    return int(val * mult)


def mem_str(nbytes: int) -> str:
    for unit, div in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if nbytes >= div:
            return f"{nbytes / div:.1f}{unit}"
    return f"{nbytes}B"


def graph_mem_bytes(capacity: int, W: int, ncols: int) -> int:
    """Store bytes for `capacity` kmer slots (keys + covg + edges)."""
    return capacity * (8 * W + 4 * ncols + ncols)


def kmers_in_budget(mem_to_use: int, W: int, ncols: int) -> int:
    """Max kmer slots that fit the budget (ref cmd_get_kmers_in_hash)."""
    per = 8 * W + 4 * ncols + ncols
    return max(mem_to_use // per, 0)


def check_plan(mem_to_use: int | None, planned_bytes: int,
               what: str = "graph"):
    """Fail fast when the plan exceeds the budget (ref
    cmd_check_mem_limit); returns a printable plan line."""
    line = f"memory plan: {what} {mem_str(planned_bytes)}"
    if mem_to_use is not None:
        line += f" / budget {mem_str(mem_to_use)}"
        if planned_bytes > mem_to_use:
            raise MemoryError(
                f"{what} needs {mem_str(planned_bytes)} but -m/--memory "
                f"budget is {mem_str(mem_to_use)}")
    return line


def device_mem_bytes(device) -> int | None:
    """Total memory of a CUDA device (torch.cuda.mem_get_info), None for
    the CPU."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]

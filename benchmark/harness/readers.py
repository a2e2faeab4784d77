"""Helpers of the metric readers in benchmark/metrics.

The span and status-line metrics cover the window's completed jobs but
the profiled one (harness.runner.Run.timed), a job each.

A reader is a module with `read(run, name)`, which returns a number or
None when the run holds nothing for it to read (the metric is then left
out of the result line).  `run` is a harness.runner.Run.
"""

from __future__ import annotations

import re


def steps_of(run, command: str) -> list:
    """The steps running `command` in the window's timed jobs."""
    return [s for j in run.timed for s in j.steps if s.command == command]


def per_job(run, total):
    """A total over the window's timed jobs divided by their number, or
    None."""
    n = len(run.timed)
    return None if n == 0 or total is None else total / n


def span_total(run, command: str, names) -> float | None:
    """Seconds of the port's spans `names` in `command`'s steps."""
    steps = steps_of(run, command)
    if not steps or not any(n in s.spans for s in steps for n in names):
        return None
    return sum(s.spans.get(n, 0.0) for s in steps for n in names)


def status_total(run, command: str, pattern: str) -> float | None:
    """Sum over `command`'s steps of the seconds that a status line
    matching `pattern` (one group: the seconds) reports."""
    rx = re.compile(pattern)
    vals = [float(m.group(1)) for s in steps_of(run, command)
            for m in [rx.search(s.status)] if m]
    return sum(vals) if vals else None


def add(*vals):
    """The sum of the values that are not None, or None if all are."""
    vals = [v for v in vals if v is not None]
    return sum(vals) if vals else None

"""thread.kernels_per_step: device kernels of the profiled job that start
inside a host range named `walk` (the port's span around the linked
walk, on the profiler's timeline) over that job's walker steps (the
counter `walk.steps` of its `time split:` lines)."""

import bisect
import re

STEPS = re.compile(r"time split: .*\bwalk\.steps (\d+)")


def walk_ranges(prof) -> list:
    """The profiled job's host ranges named `walk`, merged, in order."""
    merged = []
    for iv in sorted((iv for iv in prof.host_ops if iv.name == "walk"),
                     key=lambda iv: iv.start):
        if merged and iv.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], iv.end)
        else:
            merged.append([iv.start, iv.end])
    return merged


def job_steps(job) -> int:
    """Walker steps of the job's `thread` steps, 0 without the counter."""
    return sum(int(m.group(1)) for s in job.steps if s.command == "thread"
               for m in [STEPS.search(s.status)] if m)


def read(run, name):
    prof, job = run.profile, run.profiled_job
    if prof is None or job is None or not prof.device_ops:
        return None
    ranges, steps = walk_ranges(prof), job_steps(job)
    if not ranges or not steps:
        return None
    starts = [iv.start for iv in prof.kernels()]
    n = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
            for s, e in ranges)
    return n / steps

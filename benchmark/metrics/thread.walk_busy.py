"""thread.walk_busy: how busy the card is inside the linked walk, in %:
the device-busy seconds (harness.profile.Profile.busy) inside the
profiled job's `walk` ranges over the mean `walk` span seconds of the
window's timed jobs.  The split of device.idle: the profiler stretches
the host's part of the job it traces, not the card's."""

from benchmark.harness import readers as R
from benchmark.harness import spec

_kps = spec.metric_reader("thread.kernels_per_step")


def busy_in(busy: list, ranges: list) -> float:
    """Seconds of the merged intervals `busy` that lie inside the merged,
    ordered intervals `ranges`."""
    total, i = 0.0, 0
    for s, e in ranges:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            total += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return total


def read(run, name):
    prof = run.profile
    if prof is None or not prof.device_ops:
        return None
    ranges = _kps.walk_ranges(prof)
    walk_s = R.per_job(run, R.span_total(run, "thread", ["walk"]))
    if not ranges or not walk_s:
        return None
    return 100.0 * busy_in(prof.busy(), ranges) / walk_s

"""device.idle.thread_plain: device.idle's share for the plain threading
cell, whose whole-sample job (47-55 s) often leaves the traced window no
job but the profiled one.  Where the window holds an unprofiled job it
reads as device.idle does; otherwise it divides by the profiled job's own
wall time, which the profiler stretches (the traced job took 53.7 s on
an H100's host, the unprofiled ones 47.4-54.6 s), so it reads the idle
share a little high."""

from benchmark.harness import spec

_idle = spec.metric_reader("device.idle")


def read(run, name):
    value = _idle.read(run, name)
    prof, job = run.profile, run.profiled_job
    if value is not None or prof is None or not prof.device_ops \
            or job is None or job.seconds <= 0:
        return value
    return 100.0 * (1.0 - prof.busy_s() / job.seconds)

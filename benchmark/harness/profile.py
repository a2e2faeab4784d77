"""One job under torch.profiler, reduced to what the per-layer readers
and the result's `breakdown` need.

Each step of the profiled job runs inside `record_function("step:<cmd>")`
and the whole job inside `record_function("bench_job")`, so a reader can
take the device operations of one command.  Device operations are every
event the profiler puts on the card (kernels, copies, fills); kernels are
those that are neither copies nor fills.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

JOB_MARK = "bench_job"
NAME_CHARS = 160          # a kernel's name in the breakdown
STEP_MARK = "step:"


class Interval:
    __slots__ = ("name", "start", "end")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end   # seconds


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _raw_events(prof):
    """(name, is_device, start s, end s) of every event of the profile.
    Reads the profiler's flat event list; no tree is built."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            dev = e.device_type() in (DeviceType.CUDA,)
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            yield e.name(), dev, s, s + d
        return
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        yield e.name, dev, e.time_range.start * 1e-6, e.time_range.end * 1e-6


class Profile:
    """The device operations and host marks of one profiled job."""

    def __init__(self, prof):
        self.device_ops, self.host_ops, marks = [], [], {}
        for name, dev, s, e in _raw_events(prof):
            mark = name == JOB_MARK or name.startswith(STEP_MARK)
            if dev:
                # the profiler mirrors each mark on the device's timeline
                # as an annotation: no operation ran in it
                if not mark:
                    self.device_ops.append(Interval(name, s, e))
            else:
                if mark:
                    marks.setdefault(name, []).append(Interval(name, s, e))
                self.host_ops.append(Interval(name, s, e))
        self.device_ops.sort(key=lambda iv: iv.start)
        self.host_ops.sort(key=lambda iv: iv.start)
        self._host_starts = [iv.start for iv in self.host_ops]
        self.marks = marks
        job = marks.get(JOB_MARK)
        if job:
            self.t0, self.t1 = job[0].start, job[0].end
        elif self.device_ops:
            self.t0 = self.device_ops[0].start
            self.t1 = max(iv.end for iv in self.device_ops)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self, within: Interval | None = None) -> list:
        out = [iv for iv in self.device_ops if _is_kernel(iv.name)]
        if within is not None:
            out = [iv for iv in out if within.start <= iv.start < within.end]
        return out

    def steps(self, command: str) -> list:
        return self.marks.get(STEP_MARK + command, [])

    def busy(self) -> list:
        """Merged intervals in which some device operation ran, clipped to
        the job."""
        merged = []
        for iv in self.device_ops:
            s, e = max(iv.start, self.t0), min(iv.end, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def top_device_ops(self, n: int = 10) -> list:
        """Device seconds of the job summed by operation name (a name cut
        to its first NAME_CHARS characters)."""
        tot = collections.Counter()
        for iv in self.device_ops:
            tot[iv.name[:NAME_CHARS]] += iv.end - iv.start
        return [[name, sec] for name, sec in tot.most_common(n)]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at time t, with the step."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        # host ops nest, so the innermost is the latest start that covers t
        for iv in reversed(self.host_ops[max(0, i - 4096):i]):
            if iv.end >= t and iv.name != JOB_MARK \
                    and not iv.name.startswith(STEP_MARK):
                best = iv.name
                break
        step = next((m[len(STEP_MARK):] for m, ivs in self.marks.items()
                     if m.startswith(STEP_MARK)
                     and any(v.start <= t <= v.end for v in ivs)), "job")
        return (f"{step}: {best[:NAME_CHARS]}" if best
                else f"{step}: host python")

    def idle_gaps(self, n: int = 10, longest: int = 2000) -> list:
        """Idle seconds of the job summed by what the host was doing, over
        its `longest` longest gaps between device operations."""
        busy = self.busy()
        edges = [self.t0] + [x for se in busy for x in se] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        tot = collections.Counter()
        for length, start in gaps[:longest]:
            tot[self._host_at(start + length / 2)] += length
        return [[name, sec] for name, sec in tot.most_common(n)]


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """Yields a holder whose .prof is the torch profiler once the block
    ends (None when not enabled); Profile(holder.prof) reduces it, which
    takes seconds for a job of a million kernels, so the caller does it
    after its window."""
    class Holder:
        prof = None
    h = Holder()
    if not enabled:
        yield h
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(JOB_MARK):
            yield h
        if cuda:
            torch.cuda.synchronize()
    h.prof = prof


def step_mark(enabled: bool, command: str):
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(STEP_MARK + command)

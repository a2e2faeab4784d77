"""thread.gapfill_host_s: seconds a job of `thread` spends in the gap
filler's host loops around the linked walk: the spans `gaps` (runs, gaps
and the walkers' seeds) and `bridge` (walker paths to bridged reads)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.span_total(run, "thread", ["gaps", "bridge"]))

"""thread.gapfill_s: seconds a job of `thread` spends filling gaps (span
`gapfill`, which holds the linked walk)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.span_total(run, "thread", ["gapfill"]))

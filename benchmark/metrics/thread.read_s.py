"""thread.read_s: seconds a job of `thread` spends in its reader (span
`read`)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.span_total(run, "thread", ["read"]))

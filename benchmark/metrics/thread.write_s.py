"""thread.write_s: seconds a job of `thread` spends writing its .ctp
(span `write`)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.span_total(run, "thread", ["write"]))

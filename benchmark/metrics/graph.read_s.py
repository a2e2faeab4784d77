"""graph.read_s: seconds a job of `build` spends reading its input (the
status line `read N batches in X s`), over the window, a job."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.status_total(
        run, "build", r"read \d+ batches in ([0-9.]+)s"))

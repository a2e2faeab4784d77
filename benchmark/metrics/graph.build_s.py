"""graph.build_s: seconds a job spends in the build epochs and the LSM
fold (`build`'s status line `built N kmers ... in X s`)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.status_total(
        run, "build", r"built \d+ kmers from \d+ batches in ([0-9.]+)s"))

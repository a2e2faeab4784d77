"""graph.table_s: seconds a job spends building lookup tables on the host
(the `table` spans of `clean` and `unitigs`)."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.add(R.span_total(run, "clean", ["table"]),
                                R.span_total(run, "unitigs", ["table"])))

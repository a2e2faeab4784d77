"""graph.phases_s: seconds a job spends in the graph phases of `clean`
and `unitigs`: the `adjacency`, `prune`, `doubling` and `extract` spans,
less the `table` spans that the adjacency span holds (graph.table_s)."""

from benchmark.harness import readers as R

PHASES = ["adjacency", "prune", "doubling", "extract"]


def read(run, name):
    total = R.add(R.span_total(run, "clean", PHASES),
                  R.span_total(run, "unitigs", PHASES))
    if total is None:
        return None
    table = R.add(R.span_total(run, "clean", ["table"]),
                  R.span_total(run, "unitigs", ["table"])) or 0.0
    return R.per_job(run, total - table)

"""graph.write_s: seconds a job spends writing: `build`'s status line
`wrote ... in X s` and the `write` spans of `clean` and `unitigs`."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.add(
        R.status_total(run, "build", r"wrote \d+ kmers .* in ([0-9.]+)s"),
        R.span_total(run, "clean", ["write"]),
        R.span_total(run, "unitigs", ["write"])))

"""thread.walk_steps: steps of the linked walker a job of `thread`: the
counter `walk.steps` (iterations of links/walk.walk_linked's step loop)
on each step's `time split:` status line, over the window's timed jobs."""

from benchmark.harness import readers as R


def read(run, name):
    return R.per_job(run, R.status_total(
        run, "thread", r"time split: .*\bwalk\.steps (\d+)"))

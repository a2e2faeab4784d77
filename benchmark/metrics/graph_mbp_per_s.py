"""graph_mbp_per_s: Mbp of read bases of every job completed in the
window over all those jobs' seconds (host clock)."""


def read(run, name):
    jobs = run.done
    secs = sum(j.seconds for j in jobs)
    return sum(j.bases for j in jobs) / 1e6 / secs if secs > 0 else None

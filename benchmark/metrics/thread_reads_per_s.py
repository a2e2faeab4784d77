"""thread_reads_per_s: reads of every job completed in the window over
all those jobs' seconds (host clock)."""


def read(run, name):
    jobs = run.done
    secs = sum(j.seconds for j in jobs)
    return sum(j.reads for j in jobs) / secs if secs > 0 else None

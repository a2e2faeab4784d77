"""thread.kernels_per_read: device kernels of the profiled job (every
one the profiler saw on the card in it, copies and fills left out) over
the reads that job threaded.  Counted at the benchmark's boundary, so it
reads the same whichever code launches them."""


def read(run, name):
    prof, job = run.profile, run.profiled_job
    if prof is None or job is None or not job.reads:
        return None
    n = len(prof.kernels())
    return n / job.reads if n else None

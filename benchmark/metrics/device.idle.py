"""device.idle.<cell kind>: the share of a job's wall time in which no
operation ran on the card, in %: 1 - busy / job, where busy is the union
of the device operations' intervals in the profiled job (torch.profiler)
and job the mean wall time of the window's jobs that ran without the
profiler, which stretches the host's part of the job it traces."""


def read(run, name):
    prof = run.profile
    timed = [j for j in run.done if j is not run.profiled_job]
    if prof is None or not prof.device_ops or not timed:
        return None
    job_s = sum(j.seconds for j in timed) / len(timed)
    return 100.0 * (1.0 - prof.busy_s() / job_s)

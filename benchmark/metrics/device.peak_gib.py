"""device.peak_gib.<cell kind>: torch.cuda.max_memory_allocated() over
the window (reset at its start), in GiB."""


def read(run, name):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30

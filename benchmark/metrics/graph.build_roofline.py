"""graph.build_roofline: the least time the graph build could take over
the device time of every kernel the profiled job's `build` command
launched, in %.

The least time is the bytes that the build's input and output need, each
read or written once, over the card's memory bandwidth: the read bases in
(one byte a base) and the counted store out (a record of W 8-byte key
words and, a colour, a 4-byte count and an edge byte).  The bytes follow
from these counts alone, not from which kernels ran or how they merge,
so the share reads the same work whatever implements it.
"""

import re

from benchmark.harness.peaks import HBM_BYTES_PER_S


def build_bytes(read_bases: int, kmers: int, k: int, colours: int) -> int:
    words = (k + 31) // 32
    return read_bases + kmers * (8 * words + 5 * colours)


def read(run, name):
    prof, job = run.profile, run.profiled_job
    if prof is None or job is None:
        return None
    marks = prof.steps("build")
    step = next((s for s in job.steps if s.command == "build"), None)
    if not marks or step is None:
        return None
    m = re.search(r"built (\d+) kmers", step.status)
    kernel_s = sum(iv.end - iv.start for iv in prof.kernels(marks[0]))
    if not m or kernel_s <= 0:
        return None
    least = build_bytes(job.bases, int(m.group(1)), run.config["k"],
                        run.config["colours"]) / HBM_BYTES_PER_S
    return 100.0 * least / kernel_s

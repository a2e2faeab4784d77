"""graph.fold_ratio: how many times the build's LSM fold moves the final
store: the bytes its merges read and write (the counter `fold.bytes` of
`build`'s `time split:` line) over the bytes of the store it builds (the
kmers of its status line `built N kmers`, a record of W 8-byte key words
and, a colour, a 4-byte count and an edge byte), summed over the
window's timed jobs.  It reads the same whichever engine merges."""

from benchmark.harness import readers as R


def read(run, name):
    moved = R.status_total(run, "build", r"time split: .*\bfold\.bytes (\d+)")
    kmers = R.status_total(run, "build", r"built (\d+) kmers")
    if moved is None or not kmers:
        return None
    words = (run.config["k"] + 31) // 32
    return moved / (kmers * (8 * words + 5 * run.config["colours"]))

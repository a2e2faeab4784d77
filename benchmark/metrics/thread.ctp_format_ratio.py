"""thread.ctp_format_ratio: kmers the `.ctp` writer turns into text over
the kmers it writes (those with links): the counters
`ctp.kmers_formatted` and `ctp.kmers_written` of `thread`'s `time split:`
status lines, each summed over the window's timed jobs.  1 when the
writer formats only what it writes."""

from benchmark.harness import readers as R


def read(run, name):
    formatted = R.status_total(
        run, "thread", r"time split: .*\bctp\.kmers_formatted (\d+)")
    written = R.status_total(
        run, "thread", r"time split: .*\bctp\.kmers_written (\d+)")
    if formatted is None or not written:
        return None
    return formatted / written

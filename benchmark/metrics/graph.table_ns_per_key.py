"""graph.table_ns_per_key: nanoseconds the host table build takes a key:
the `table` spans of `clean` and `unitigs` over the keys of the tables
they built (the counter `table.keys` of their `time split:` lines; a
table found in the cache adds no key and no span), summed over the
window's timed jobs."""

from benchmark.harness import readers as R

KEYS = r"time split: .*\btable\.keys (\d+)"


def read(run, name):
    secs = R.add(R.span_total(run, "clean", ["table"]),
                 R.span_total(run, "unitigs", ["table"]))
    keys = R.add(R.status_total(run, "clean", KEYS),
                 R.status_total(run, "unitigs", KEYS))
    if secs is None or not keys:
        return None
    return 1e9 * secs / keys

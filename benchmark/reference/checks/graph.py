"""The check of a graph job (build -> clean -T -U -> unitigs): the raw
graph, the cleaned graph and the unitigs of the window's last completed
job against the plain reference's, worked out from the same reads; and
every other completed job's output files against that job's (the inputs
are the same, so the outputs must be)."""

from benchmark.reference import compare, dbg


def numbers(got_raw, got_clean, got_unitigs, raw, k) -> list:
    """(name, value, limit) rows: records or unitigs that differ from
    those of the reference's raw graph `raw` (keys, covg, edges)."""
    rows = [("raw_diff", compare.record_diff(got_raw, compare.records(*raw)),
             0)]
    clean = dbg.clean(*raw, k)
    rows.append(("clean_diff",
                 compare.record_diff(got_clean, compare.records(*clean)), 0))
    rows.append(("unitigs_diff", compare.unitig_diff(
        got_unitigs, dbg.unitigs(clean[0], clean[2], k)), 0))
    return rows


def check(run) -> list:
    done = run.done
    if not done:
        return [("jobs_completed", 0, -1)]
    raw, clean, fasta = run.driver.expand(run.traffic["job"]["outputs"],
                                          done[-1].index)
    k = run.config["k"]
    rows = numbers(compare.read_ctx(raw), compare.read_ctx(clean),
                   compare.read_fasta(fasta),
                   dbg.build(run.driver.reads, k, run.device), k)
    last = done[-1].digests
    rows.append(("jobs_differing", sum(j.digests != last for j in done), 0))
    return rows

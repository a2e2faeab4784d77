"""The port's graph job at two key words (W = 2) on the CPU: `build -k`,
`clean -T -U` and `unitigs` through the CLI on a seeded 20 kbp genome
with repeat families, at k = 33, 61 and 63, each output held to the
benchmark's plain two-word reference (benchmark/reference/dbg_wide.py),
which shares no code with the port."""

import os
import sys

import pytest

from mccortex_tpu_torch.cli.main import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.data import synth  # noqa: E402
from benchmark.reference import compare, dbg_wide  # noqa: E402


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """2,666 reads of 150 bp (20x, 0.3 % substitutions) as FASTQ."""
    _, reads, _ = synth.genome_and_reads(20_000, 20, 5)
    d = tmp_path_factory.mktemp("k61")
    synth.write_fastq(str(d / "reads.fq"), reads)
    return d, reads


@pytest.mark.parametrize("k", [33, 61, 63])
def test_graph_job_matches_two_word_reference(sample, k):
    d, reads = sample
    raw, clean, fa = (str(d / f"{n}{k}.{x}") for n, x in
                      (("raw", "ctx"), ("clean", "ctx"), ("unitigs", "fa")))
    assert port_main(["build", "-k", str(k), "--sample", "s", "--seq",
                      str(d / "reads.fq"), "-f", raw, "--device",
                      "cpu"]) == 0
    assert port_main(["clean", "-T", "-U", "-f", "-o", clean, raw,
                      "--device", "cpu"]) == 0
    assert port_main(["unitigs", "-f", "-o", fa, clean, "--device",
                      "cpu"]) == 0
    got_raw = compare.read_ctx(raw)
    assert got_raw[0].shape[1] == 2
    want = dbg_wide.build(reads, k, "cpu")
    want_clean = dbg_wide.clean(*want, k)
    assert len(want_clean[0]) < len(want[0])
    assert compare.record_diff(got_raw, dbg_wide.records(*want, k)) == 0
    assert compare.record_diff(compare.read_ctx(clean),
                               dbg_wide.records(*want_clean, k)) == 0
    want_unitigs = dbg_wide.unitigs(want_clean[0], want_clean[2], k)
    assert len(want_unitigs) > 1
    assert compare.unitig_diff(compare.read_fasta(fa), want_unitigs) == 0

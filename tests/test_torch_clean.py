"""The port's cleaning (graph.prune, graph.clean) and its `clean` and
`unitigs` commands against mccortex_tpu on the same inputs, on the CPU.
Integer outputs, CSV text and file bytes: exact equality, no tolerance;
the threshold fit is a numpy copy and must give the same floats."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import build as jb
from mccortex_tpu.graph import clean as jclean
from mccortex_tpu.graph import prune as jprune
from mccortex_tpu.graph import store as jstore
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import clean as tclean
from mccortex_tpu_torch.graph import prune as tprune
from mccortex_tpu_torch.graph import store as tstore

from test_ctx_io import write_fasta
from test_graph_build import batchify
from test_torch_unitigs import port_graph
from util import random_dna


def _reads_with_errors(seed, glen, nreads, rlen, err):
    """Reads of a random genome with substitutions: a coverage histogram
    with an error peak at 1 and a genome peak."""
    rng = np.random.default_rng(seed)
    genome = random_dna(glen, seed=seed)
    out = []
    for _ in range(nreads):
        s = int(rng.integers(0, glen - rlen))
        r = list(genome[s:s + rlen])
        for j in np.nonzero(rng.random(rlen) < err)[0]:
            r[j] = "ACGT"[(("ACGT".index(r[j])) + 1) % 4]
        out.append("".join(r))
    return out


def _host_eq(tg, jg):
    for a, b in zip(tstore.to_host(tg), jstore.to_host(jg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=[(11, 1), (31, 2), (33, 1)],
                ids=["k11", "k31-2col", "k33"])
def graph(request):
    k, ncols = request.param
    reads = _reads_with_errors(k, 600, 120, 70, 0.01)
    inputs = [(r, i % ncols) for i, r in enumerate(reads)]
    jg = jb.build(batchify(inputs), k, ncols=ncols)
    return jg, port_graph(jg)


def test_prune_to_mask_matches_jax(graph):
    jg, tg = graph
    rng = np.random.default_rng(jg.k)
    keep = rng.random(jg.capacity) < 0.7
    j2 = jprune.prune_to_mask(jg, jnp.asarray(keep))
    t2 = tprune.prune_to_mask(tg, torch.from_numpy(keep))
    assert t2.n == int(j2.n) and t2.capacity == j2.capacity
    np.testing.assert_array_equal(t2.keys.numpy().view(np.uint64),
                                  np.asarray(j2.keys))
    np.testing.assert_array_equal(t2.covg.numpy().view(np.uint32),
                                  np.asarray(j2.covg))
    np.testing.assert_array_equal(t2.edges.numpy(), np.asarray(j2.edges))


@pytest.mark.parametrize("thresh,tips", [(0, 0), (2, 0), (0, 20), (3, 40)])
def test_clean_graph_matches_jax(graph, thresh, tips):
    jg, tg = graph
    _host_eq(tclean.clean_graph(tg, thresh, tips),
             jclean.clean_graph(jg, thresh, tips))


def test_histograms_match_jax(graph):
    jg, tg = graph
    for maxcovg in (10, 1000):
        want = jclean.covg_histogram(jg, maxcovg)
        got = tclean.covg_histogram(tg, maxcovg)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tclean.cleaning_histograms(tg, 50, 20),
                         jclean.cleaning_histograms(jg, 50, 20)):
        np.testing.assert_array_equal(got, want)


def _hists():
    rng = np.random.default_rng(0)
    err = rng.poisson(0.6, 30000)
    real = rng.poisson(25, 20000)
    mix = np.bincount(np.concatenate([err[err > 0], real[real > 0]]),
                      minlength=100).astype(np.uint64)
    flat = np.full(100, 50, np.uint64)
    gap = mix.copy()
    gap[3] = 0
    low = np.bincount(rng.poisson(1.5, 5000), minlength=30).astype(np.uint64)
    hi = np.bincount(np.concatenate([rng.poisson(0.3, 2000),
                                     rng.poisson(8, 50000)]),
                     minlength=40).astype(np.uint64)
    return [mix, flat, gap, low, hi]


@pytest.mark.parametrize("i", range(5))
def test_pick_kmer_threshold_copy(i):
    hist = _hists()[i]
    hist[0] = 0
    assert tclean.pick_kmer_threshold(hist) == \
        jclean.pick_kmer_threshold(hist)


def test_csv_writers_copy(tmp_path):
    kh, uh, lh = (np.arange(30) % 7, np.arange(30) % 3, np.arange(12) % 5)
    for mod, name in ((tclean, "t"), (jclean, "j")):
        mod.write_covg_csv(str(tmp_path / f"{name}c.csv"), kh, uh)
        mod.write_len_csv(str(tmp_path / f"{name}l.csv"), lh, 21)
    for f in ("c", "l"):
        assert (tmp_path / f"t{f}.csv").read_text() == \
            (tmp_path / f"j{f}.csv").read_text()


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx_files(tmp_path_factory):
    """Raw .ctx files written by `mctx build`: one per k (k=11 and the
    W=2 k=33), and a second sample at k=11 for multi-.ctx loads."""
    d = tmp_path_factory.mktemp("ctx")
    out = {}
    for name, k, seed in (("a11", 11, 1), ("b11", 11, 2), ("a33", 33, 3)):
        fa = str(d / f"{name}.fa")
        write_fasta(fa, _reads_with_errors(seed, 700, 300, 60, 0.01))
        out[name] = str(d / f"{name}.ctx")
        assert mctx_main(["build", "-k", str(k), "--sample", name,
                          "--seq", fa, out[name]]) == 0
    return out


@pytest.mark.parametrize("inputs,flags", [
    (["a11"], ["-T", "-U"]),
    (["a33"], ["-T", "-U"]),
    (["a11", "b11"], ["-T", "-U", "-B", "2"]),
    (["a11"], ["--tips", "5", "--unitigs", "3", "-S", "-N", "1"]),
])
def test_cli_clean_matches_mctx(tmp_path, ctx_files, inputs, flags):
    paths = [ctx_files[n] for n in inputs]
    outs = {}
    for tool, run, extra in (("jax", mctx_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tool
        d.mkdir()
        csvs = ["-c", str(d / "cb.csv"), "-C", str(d / "ca.csv"),
                "-l", str(d / "lb.csv"), "-L", str(d / "la.csv")]
        assert run(["clean", *flags, *csvs, "-o", str(d / "c.ctx"),
                    *paths, *extra]) == 0
        outs[tool] = {f: (d / f).read_bytes()
                      for f in ("c.ctx", "cb.csv", "ca.csv", "lb.csv",
                                "la.csv")}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]["ca.csv"]) > 30


@pytest.mark.parametrize("fmt", [[], ["-F"], ["--gfa"], ["--dot"],
                                 ["--dot", "-P"], ["--min-len", "40"]])
def test_cli_unitigs_matches_mctx(tmp_path, ctx_files, fmt):
    for inputs in (["a11"], ["a33"], ["a11", "b11"]):
        paths = [ctx_files[n] for n in inputs]
        a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
        assert mctx_main(["unitigs", *fmt, "-f", "-o", str(a), *paths]) == 0
        assert port_main(["unitigs", *fmt, "-f", "-o", str(b), *paths,
                          "--device", "cpu"]) == 0
        assert b.read_text() == a.read_text() and len(a.read_text()) > 50


def test_cli_unitig_inputs_of_the_jax_tests(tmp_path, capsys):
    """The inputs of tests/test_unitigs_clean.py's CLI tests: clean then
    FASTA and GFA to stdout, and the fork's GFA links."""
    k = 11
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, [random_dna(150, seed=61)] * 3 + [random_dna(40, seed=62)])
    raw = str(tmp_path / "raw.ctx")
    assert mctx_main(["build", "-k", str(k), "--sample", "s", "--seq", fa,
                      raw]) == 0
    for tool, run, extra in (("jax", mctx_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        cln = str(tmp_path / f"{tool}.ctx")
        assert run(["clean", "--unitigs", "2", "-o", cln, raw, *extra]) == 0
    assert open(str(tmp_path / "jax.ctx"), "rb").read() == \
        open(str(tmp_path / "port.ctx"), "rb").read()
    cln = str(tmp_path / "jax.ctx")
    stem = random_dna(30, seed=70)
    fork = str(tmp_path / "fork.fa")
    write_fasta(fork, [stem + "A" + random_dna(20, seed=71),
                       stem + "C" + random_dna(20, seed=72)])
    fork_ctx = str(tmp_path / "fork.ctx")
    assert mctx_main(["build", "-k", "7", "--sample", "s", "--seq", fork,
                      fork_ctx]) == 0
    capsys.readouterr()
    for argv in (["unitigs", cln], ["unitigs", "--gfa", cln],
                 ["unitigs", "--gfa", fork_ctx]):
        assert mctx_main(argv) == 0
        want = capsys.readouterr().out
        assert port_main(argv + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out == want
    assert want.count("\nL\t") >= 2


def test_cli_refusals(tmp_path, ctx_files):
    out = str(tmp_path / "o.ctx")
    with pytest.raises(MemoryError, match="budget is 1.0KB"):
        port_main(["clean", "-m", "1K", "-o", out, ctx_files["a11"],
                   "--device", "cpu"])
    assert not os.path.exists(out)
    if not torch.cuda.is_available():
        assert port_main(["clean", "-T", "-o", out, ctx_files["a11"]]) == 1
        assert port_main(["unitigs", ctx_files["a11"]]) == 1
    open(out, "w").close()
    assert port_main(["clean", "-T", "-o", out, ctx_files["a11"],
                      "--device", "cpu"]) == 1        # exists, no --force

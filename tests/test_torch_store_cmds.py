"""The port's store-only commands against mctx on the CPU: view, check,
join, dist, sort, index, uniqkmers, rmsubstr and clean -m give the same
output bytes or text from `mctx-torch ... --device cpu` as from `mctx`,
on the cases of tests/test_commands2.py; the host utilities copied into
the port (utils/dna, stats, npkmer, text.edges_to_strings) and the
checks ported onto the port's kmer ops equal the originals.  Exact
equality, no tolerance."""

import numpy as np
import pytest
import torch

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.ops import kmer as jkops
from mccortex_tpu.utils import checks as jchecks
from mccortex_tpu.utils import dna as jdna
from mccortex_tpu.utils import npkmer as jnpk
from mccortex_tpu.utils import stats as jstats
from mccortex_tpu.utils import text as jtext
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.io import ctx as tctx
from mccortex_tpu_torch.ops import kmer as tkops
from mccortex_tpu_torch.utils import checks as tchecks
from mccortex_tpu_torch.utils import dna as tdna
from mccortex_tpu_torch.utils import npkmer as tnpk
from mccortex_tpu_torch.utils import stats as tstats
from mccortex_tpu_torch.utils import text as ttext

from test_ctx_io import write_fasta
from util import random_dna

K = 11


def _port(argv):
    return port_main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """The inputs of tests/test_commands2.py: a two-colour graph (B is A
    with 50 bases inserted), single-colour graphs of two random
    sequences, and of sequences sharing a segment."""
    d = tmp_path_factory.mktemp("store_cmds")
    a = random_dna(200, seed=500)
    b = a[:100] + random_dna(50, seed=501) + a[100:]
    x, y = random_dna(150, seed=510), random_dna(150, seed=511)
    shared = random_dna(80, seed=1402)
    p = {}
    for name, seqs in (("a", [a]), ("b", [b]), ("x", [x]), ("y", [y]),
                       ("xs", [random_dna(120, seed=1400) + shared]),
                       ("ys", [random_dna(120, seed=1401) + shared]),
                       ("long", [random_dna(3000, seed=7)])):
        p[name + ".fa"] = str(d / f"{name}.fa")
        write_fasta(p[name + ".fa"], seqs)
    p["d"] = d
    builds = {"ab": ["-s", "A", "--seq", p["a.fa"], "-s", "B", "--seq",
                     p["b.fa"]],
              "x": ["-s", "X", "--seq", p["x.fa"]],
              "y": ["-s", "Y", "--seq", p["y.fa"]],
              "xs": ["-s", "a", "--seq", p["xs.fa"]],
              "ys": ["-s", "b", "--seq", p["ys.fa"]],
              "long": ["-s", "L", "--seq", p["long.fa"]]}
    for name, args in builds.items():
        p[name] = str(d / f"{name}.ctx")
        assert _port(["build", "-k", str(K)] + args + ["-q", p[name]]) == 0
    p["long33"] = str(d / "long33.ctx")
    assert _port(["build", "-k", "33", "-s", "L", "--seq", p["long.fa"],
                  "-q", p["long33"]]) == 0
    return p


def _both(capsys, argv, port_argv=None):
    """Run `mctx argv` and `mctx-torch argv --device cpu`; returns
    ((rc, stdout, stderr) of mctx, the same of the port)."""
    capsys.readouterr()
    rj = mctx_main(argv)
    j = capsys.readouterr()
    rt = _port(port_argv or argv)
    t = capsys.readouterr()
    return (rj, j.out, j.err), (rt, t.out, t.err)


def _lines(err, prefix):
    return [l for l in err.splitlines() if l.startswith(prefix)]


# ---------------------------------------------------------------------------
# view and check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["-i"], ["-k"], ["-c"],
                                   ["-k", "-i", "-c"]])
def test_view_matches_mctx(graphs, capsys, flags):
    for g in ("ab", "long33"):
        (rj, oj, ej), (rt, ot, et) = _both(capsys,
                                           ["view"] + flags + [graphs[g]])
        assert rj == rt == 0 and oj == ot
        assert _lines(ej, "[mctx] graph check") == \
            _lines(et, "[mctx] graph check")


def _corrupt(case, keys, covg, edges, k):
    keys, covg, edges = keys.copy(), covg.copy(), edges.copy()
    if case == "unsorted":
        keys[[3, 4]] = keys[[4, 3]]
    elif case == "duplicate":
        keys[5] = keys[4]
    elif case == "non_canonical":
        i = int(np.nonzero(edges.any(axis=1))[0][2])
        keys[i] = jnpk.revcmp_np(keys[i:i + 1], k)[0]
    elif case == "zero_covg":
        covg[7] = 0
    elif case == "absent_edge":
        edges[9, 0] |= 0xFF
    elif case == "asymmetric":
        # a kmer loses one edge: the neighbour's edge back to it is
        # left without its symmetric bit
        i = int(np.nonzero(edges[:, 0])[0][3])
        e = int(edges[i, 0])
        edges[i, 0] = e & (e - 1)
    return keys, covg, edges


CORRUPTIONS = ["none", "unsorted", "duplicate", "non_canonical",
               "zero_covg", "absent_edge", "asymmetric"]


@pytest.mark.parametrize("case", CORRUPTIONS)
def test_check_matches_mctx(graphs, capsys, tmp_path, case):
    for g, k in (("ab", K), ("long33", 33)):
        h, keys, covg, edges = tctx.read_ctx(graphs[g])
        keys, covg, edges = _corrupt(case, keys, covg, edges, k)
        want = jchecks.check_graph_arrays(k, keys, covg, edges)
        got = tchecks.check_graph_arrays(
            k, torch.from_numpy(keys.view(np.int64)),
            torch.from_numpy(covg.view(np.int32)), torch.from_numpy(edges))
        assert got == want
        assert bool(want) == (case != "none")
        # the writer drops kmers without coverage, so the file's errors
        # are those of the arrays read back
        bad = str(tmp_path / f"{g}_{case}.ctx")
        tctx.write_ctx(bad, h, keys, covg, edges)
        want = jchecks.check_graph_arrays(k, *tctx.read_ctx(bad)[1:])
        (rj, oj, ej), (rt, ot, et) = _both(capsys, ["check", bad])
        assert rj == rt == (1 if want else 0) and oj == ot
        assert _lines(ej, "check:") == _lines(et, "check:") == \
            [f"check: {e}" for e in want]
        assert _lines(ej, f"[mctx] {bad}: OK") == \
            _lines(et, f"[mctx] {bad}: OK")


def test_check_paths_is_refused(graphs, capsys):
    """check -p is no longer refused: on the links mctx threads from two
    reads crossing a shared middle (an X), the port gives mctx's exit
    code and link status line."""
    m = random_dna(40, seed=1500)
    reads = [random_dna(40, seed=1501) + m + random_dna(40, seed=1502),
             random_dna(40, seed=1503) + m + random_dna(40, seed=1504)]
    fa, ctx, links = (str(graphs["d"] / n)
                      for n in ("xl_reads.fa", "xl.ctx", "xl.ctp.gz"))
    write_fasta(fa, reads)
    assert _port(["build", "-k", str(K), "-s", "s", "--seq", fa, "-q",
                  ctx]) == 0
    assert mctx_main(["thread", "--no-gap-fill", "--seq", fa, "-o", links,
                      ctx]) == 0
    got = []
    for run in (mctx_main, _port):
        capsys.readouterr()
        rc = run(["check", "-p", links, ctx])
        got.append((rc, _lines(capsys.readouterr().err, "[mctx] links")))
    assert got[1] == got[0]
    assert got[0][0] == 0 and "links OK (4 links" in got[0][1][0]


# ---------------------------------------------------------------------------
# join, dist, sort, index
# ---------------------------------------------------------------------------

JOIN_CASES = {
    "offsets": lambda p: [p["x"], p["y"]],
    "flatten": lambda p: ["--flatten", p["x"], p["y"]],
    "offset_and_colours": lambda p: ["3:" + p["x"], p["ab"] + ":1"],
    "intersect": lambda p: ["-i", p["ys"], p["xs"]],
    "two_intersects": lambda p: ["-i", p["xs"], "-i", p["ys"], p["xs"],
                                 p["ab"], p["ys"]],
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_join_matches_mctx(graphs, capsys, tmp_path, case):
    args = JOIN_CASES[case](graphs)
    a, b = str(tmp_path / "mctx.ctx"), str(tmp_path / "port.ctx")
    (rj, _oj, ej), (rt, _ot, et) = _both(
        capsys, ["join", "-o", a] + args, ["join", "-o", b] + args)
    assert rj == rt == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    assert _lines(ej, "[mctx] joined") == _lines(et, "[mctx] joined")
    assert _lines(ej, "[mctx] intersected") == \
        _lines(et, "[mctx] intersected")
    if "-i" not in args:    # an intersection may leave dangling edges
        assert port_main(["check", b, "--device", "cpu", "-q"]) == 0


def test_dist_matches_mctx(graphs, capsys, tmp_path):
    (rj, oj, _), (rt, ot, _) = _both(capsys, ["dist", graphs["ab"]])
    assert rj == rt == 0 and oj == ot
    lines = ot.splitlines()
    assert lines[0].split() == ["A", "B"]
    a, b = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    _both(capsys, ["dist", "-o", a, graphs["ab"]],
          ["dist", "-o", b, graphs["ab"]])
    assert open(a).read() == open(b).read() == oj


@pytest.mark.parametrize("g", ["ab", "long33"])
def test_sort_matches_mctx(graphs, capsys, tmp_path, g):
    h, keys, covg, edges = tctx.read_ctx(graphs[g])
    perm = np.random.default_rng(0).permutation(len(keys))
    scrambled = str(tmp_path / "scrambled.ctx")
    tctx.write_ctx(scrambled, h, keys[perm], covg[perm], edges[perm])
    a, b = str(tmp_path / "j.ctx"), str(tmp_path / "t.ctx")
    (rj, _, _), (rt, _, _) = _both(capsys, ["sort", "-o", a, scrambled],
                                   ["sort", "-o", b, scrambled])
    assert rj == rt == 0
    assert open(a, "rb").read() == open(b, "rb").read() == \
        open(graphs[g], "rb").read()
    # in place, the default
    assert _port(["sort", scrambled]) == 0
    assert open(scrambled, "rb").read() == open(a, "rb").read()


@pytest.mark.parametrize("args", [[], ["-b", "7"], ["-s", "1K"]],
                         ids=["default", "block_kmers", "block_bytes"])
def test_index_matches_mctx(graphs, capsys, tmp_path, args):
    a, b = str(tmp_path / "j.idx"), str(tmp_path / "t.idx")
    for g in ("ab", "long33"):
        (rj, _, _), (rt, _, _) = _both(
            capsys, ["index", "-f", "-o", a] + args + [graphs[g]],
            ["index", "-f", "-o", b] + args + [graphs[g]])
        assert rj == rt == 0
        assert open(a).read() == open(b).read()
    assert len(open(b).read().splitlines()) >= 2
    with pytest.raises(SystemExit):
        _port(["index", "-b", "4", "-s", "1K", "-f", "-o", b, graphs["ab"]])


# ---------------------------------------------------------------------------
# uniqkmers, rmsubstr
# ---------------------------------------------------------------------------

UNIQ_CASES = {"flank": lambda p: ["-k", "9", "-F", p["a.fa"], "0"],
              "plain": lambda p: ["-k", "9", "5"],
              "avoid": lambda p: ["-k", str(K), "--seed", "3", "-g", p["ab"],
                                  "-1", p["b.fa"], "-F", p["x.fa"], "4"]}


@pytest.mark.parametrize("case", list(UNIQ_CASES))
def test_uniqkmers_matches_mctx(graphs, capsys, tmp_path, case):
    args = UNIQ_CASES[case](graphs)
    (rj, oj, _), (rt, ot, _) = _both(capsys, ["uniqkmers"] + args)
    assert rj == rt == 0 and oj == ot and oj.startswith(">")
    a, b = str(tmp_path / "j.fa"), str(tmp_path / "t.fa")
    _both(capsys, ["uniqkmers", "-o", a] + args,
          ["uniqkmers", "-o", b] + args)
    assert open(a).read() == open(b).read() == oj


@pytest.fixture(scope="module")
def substr_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rmsubstr")
    s = random_dna(100, seed=540)
    fa = str(d / "r.fa")
    write_fasta(fa, [s, s[10:60], jdna.revcomp(s[20:80]),
                     random_dna(50, seed=541), s[30:90]])
    fq = str(d / "r.fq")
    with open(fq, "w") as fh:
        for i, r in enumerate([s, s[5:50], random_dna(40, seed=542)]):
            q = "".join(chr(33 + (j * 7) % 41) for j in range(len(r)))
            fh.write(f"@q{i}\n{r}\n+\n{q}\n")
    return fa, fq


@pytest.mark.parametrize("args", [["{fa}"], ["-v", "{fa}"],
                                  ["-F", "fastq", "{fq}", "{fa}"],
                                  ["-k", "11", "-F", "FASTA", "{fq}"]],
                         ids=["fasta", "invert", "fastq", "kmer"])
def test_rmsubstr_matches_mctx(substr_inputs, capsys, tmp_path, args):
    fa, fq = substr_inputs
    args = [x.format(fa=fa, fq=fq) for x in args]
    a, b = str(tmp_path / "j.out"), str(tmp_path / "t.out")
    (rj, _, ej), (rt, _, et) = _both(capsys, ["rmsubstr", "-o", a] + args,
                                     ["rmsubstr", "-o", b] + args)
    assert rj == rt == 0
    assert open(a).read() == open(b).read()
    assert _lines(ej, "[mctx] rmsubstr") == _lines(et, "[mctx] rmsubstr")
    (rj, oj, _), (rt, ot, _) = _both(capsys, ["rmsubstr"] + args)
    assert oj == ot == open(b).read()


# ---------------------------------------------------------------------------
# clean -m
# ---------------------------------------------------------------------------

def test_clean_memory_budget_matches_mctx(graphs, capsys, tmp_path):
    a, b = str(tmp_path / "j.ctx"), str(tmp_path / "t.ctx")
    args = ["--unitigs", "0", "-m", "1G"]
    (rj, _, ej), (rt, _, et) = _both(
        capsys, ["clean", "-o", a] + args + [graphs["ab"], graphs["x"]],
        ["clean", "-o", b] + args + [graphs["ab"], graphs["x"]])
    assert rj == rt == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    plan = _lines(et, "[mctx] memory plan")
    assert plan == _lines(ej, "[mctx] memory plan") and "/ budget 1.0GB" in \
        plan[0]
    for main in (mctx_main, _port):
        with pytest.raises(MemoryError, match="budget is 1.0KB"):
            main(["clean", "-m", "1K", "-f", "-o", b, graphs["ab"]])


# ---------------------------------------------------------------------------
# host utilities copied into the port, and the kmer op checks need
# ---------------------------------------------------------------------------

def test_dna_and_stats_match_jax():
    for s in ("ACGTTGCA", "acgtN", random_dna(37, seed=3), ""):
        assert tdna.revcomp(s) == jdna.revcomp(s)
        assert tdna.canonical_str(s) == jdna.canonical_str(s)
    for lens, gs in (([], None), ([5, 1, 9, 3, 3], None),
                     ([100, 40, 40, 7], 500), ([10, 10], 1000)):
        assert tstats.contig_stats(lens, gs) == jstats.contig_stats(lens, gs)


@pytest.mark.parametrize("k", [11, 33, 63])
def test_npkmer_and_text_match_jax(k):
    seq = random_dna(300, seed=k) + "N" + random_dna(50, seed=k + 1)
    for t, j in zip(tnpk.seq_canonical_keys(seq, k),
                    jnpk.seq_canonical_keys(seq, k)):
        np.testing.assert_array_equal(t, j)
    codes = tnpk.seq_to_codes_np(seq)
    kmers, valid = tnpk.rolling_kmers_np(codes, k)
    jk, jv = jnpk.rolling_kmers_np(codes, k)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(kmers[valid], jk[jv])
    np.testing.assert_array_equal(tnpk.revcmp_np(kmers, k),
                                  jnpk.revcmp_np(kmers, k))
    keys = tnpk.canonical_np(kmers[valid], k)[0]
    assert ttext.kmers_to_strings(keys, k) == jtext.kmers_to_strings(keys, k)
    # first_base, which the checks need, on the port's int64 words
    got = tkops.first_base(torch.from_numpy(keys.view(np.int64)), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jkops.first_base(keys, k)))
    edges = np.random.default_rng(k).integers(0, 256, (40, 3), np.uint8)
    assert ttext.edges_to_strings(edges) == jtext.edges_to_strings(edges)

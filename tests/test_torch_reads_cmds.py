"""`mctx-torch links`, `reads` and `coverage` against `mctx` on the CPU:
the same files (a .ctp decompressed, the date fixed, only the header's
`generator` masked; FASTA/FASTQ decompressed; CSV, DOT and threshold
files as they are), the same standard output, the same status lines and
exit codes.

The cases are those of tests/test_links_cli.py (a k = 9 graph with a
two-junction link tree), tests/test_correct.py::test_cli_links_clean,
tests/test_commands2.py:86-108 (reads and coverage on a 2-colour k = 11
graph) and tests/test_cli_flags.py:156 and :256 (degree symbols, several
graphs), with every flag of the three commands.  Graphs and link files
are written by the port (their bytes equal mctx's: tests/test_torch_
{build,links_cli}.py).
"""

import gzip
import os
import re
import time

import pytest

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu_torch.cli.main import main as port_main

from test_ctx_io import write_fasta
from util import random_dna

DATE = "2026-01-02 03:04:05"


@pytest.fixture(autouse=True)
def fixed_date(monkeypatch):
    """Both packages stamp the .ctp header through time.strftime."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: DATE)


def _port(argv):
    return port_main(argv + ["--device", "cpu"])


def _content(path):
    data = open(path, "rb").read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return re.sub(rb'"generator": "[^"]*"', b'"generator": "-"', data)


def _status(err, *prefixes):
    return [line for line in err.splitlines()
            if line.startswith(tuple("[mctx] " + p for p in prefixes))]


def _run(capsys, run, argv):
    capsys.readouterr()
    try:
        rc = run(argv)
    except SystemExit as e:
        rc = ("exit", e.code)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def both(capsys, work, argv):
    """argv through mctx and through the port (--device cpu) in the
    directory `work`, with the same paths (a .ctp header records the
    command line); each side's new files are read and then removed.
    Returns [(rc, {name: content}, stdout, stderr)] for (mctx, port)."""
    os.makedirs(work, exist_ok=True)
    res = []
    for run in (mctx_main, _port):
        before = set(os.listdir(work))
        rc, out, err = _run(capsys, run, argv)
        files = {}
        for name in sorted(set(os.listdir(work)) - before):
            path = os.path.join(work, name)
            files[name] = _content(path)
            os.remove(path)
        res.append((rc, files, out, err))
    return res


def assert_same(res, *status):
    (jrc, jf, jout, jerr), (trc, tf, tout, terr) = res
    assert trc == jrc
    assert sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name
    assert tout == jout
    assert _status(terr, *status) == _status(jerr, *status)


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def threaded(tmp_path_factory):
    """tests/test_links_cli.py's reads (k = 9): a link tree with two
    junctions, seen 5, 1, 3 and 1 times; and test_correct.py's
    test_cli_links_clean reads (one read 3x, another once)."""
    d = tmp_path_factory.mktemp("links_cmd")
    p1, p2 = random_dna(14, 11), random_dna(14, 12)
    common = random_dna(30, 1)
    a, b = random_dna(12, 2), random_dna(12, 3)
    mid = random_dna(14, 4)
    c, e = random_dna(12, 5), random_dna(12, 6)
    m = random_dna(30, seed=750)
    r1 = random_dna(20, seed=751) + m + random_dna(20, seed=752)
    r2 = random_dna(20, seed=753) + m + random_dna(20, seed=754)
    sets = {"tree": [p1 + common + a + mid + c] * 5
            + [p1 + common + a + mid + e] + [p1 + common + b] * 3
            + [p2 + common + b],
            "two": [r1, r1, r1, r2]}
    out = {}
    for name, reads in sets.items():
        fa = str(d / f"{name}.fa")
        write_fasta(fa, reads)
        ctx, ctp = str(d / f"{name}.ctx"), str(d / f"{name}.ctp.gz")
        assert _port(["build", "-k", "9", "--sample", "S", "--seq", fa,
                      ctx, "-q"]) == 0
        assert _port(["thread", "--seq", fa, "-o", ctp, ctx, "-q"]) == 0
        out[name] = (ctx, ctp)
    out["d"] = d
    return out


LINKS = {
    "clean": ["--clean", "3", "-o", "W/clean.ctp.gz"],
    "inspect": ["--list", "W/list.csv", "--threshold", "W/thr.txt",
                "--covg-hist", "W/hist.csv", "--plot", "W/tree.dot",
                "--max-dist", "8"],
    "limit": ["--limit", "1", "-o", "W/lim.ctp.gz"],
    "list_threshold_then_clean": ["-l", "W/l.csv", "-T", "W/t.txt", "-c",
                                  "2", "-o", "W/c.ctp", "-C", "50", "-D",
                                  "4", "-H", "W/h.csv"],
    "clean_then_list_threshold": ["-c", "2", "-l", "W/l.csv", "-T",
                                  "W/t.txt", "-o", "W/c.ctp.gz"],
    "plot_limit": ["-P", "W/p.dot", "-L", "2"],
    "clean_without_out": ["-c", "2"],
}


@pytest.mark.parametrize("case", list(LINKS))
def test_links_matches_mctx(capsys, threaded, case):
    ctx, ctp = threaded["tree"]
    work = str(threaded["d"] / f"links_{case}")
    argv = ["links"] + [x.replace("W/", work + "/") for x in LINKS[case]] \
        + [ctx, ctp]
    res = both(capsys, work, argv)
    assert_same(res, "link", "links")
    rc, files = res[1][0], res[1][1]
    if case == "clean_without_out":
        assert rc == ("exit", 2) and not files
        return
    assert rc == 0 and files
    if case == "inspect":
        assert files["thr.txt"].startswith(b"sumcovgs=")
        assert files["tree.dot"].startswith(b"digraph G {")
        assert len(files["hist.csv"].splitlines()) == 9
    if "clean" in case:
        assert "link clean:" in res[1][3]


def test_links_clean_of_two_reads_matches_mctx(capsys, threaded):
    """tests/test_correct.py::test_cli_links_clean: the once-seen read's
    links go, the thrice-seen read's stay."""
    ctx, ctp = threaded["two"]
    work = str(threaded["d"] / "links_two")
    res = both(capsys, work, ["links", "--clean", "2", "-o",
                              work + "/lc.ctp.gz", ctx, ctp])
    assert_same(res, "link")
    m = re.search(r"link clean: (\d+) -> (\d+) links", res[1][3])
    assert m and int(m.group(2)) < int(m.group(1))


# ---------------------------------------------------------------------------
# reads and coverage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_colour(tmp_path_factory):
    """tests/test_commands2.py's two-colour graph (k = 11): a, and b = a
    with 50 bp inserted; query reads of several lengths (each length a
    lookup of its own), one shorter than k, one with Ns, one foreign."""
    d = tmp_path_factory.mktemp("reads_cmd")
    a = random_dna(200, seed=500)
    b = a[:100] + random_dna(50, seed=501) + a[100:]
    other = random_dna(80, seed=520)
    fa_a, fa_b = str(d / "a.fa"), str(d / "b.fa")
    write_fasta(fa_a, [a])
    write_fasta(fa_b, [b])
    ctx = str(d / "ab.ctx")
    assert _port(["build", "-k", "11", "--sample", "A", "--seq", fa_a,
                  "--sample", "B", "--seq", fa_b, ctx, "-q"]) == 0
    ca, cb = str(d / "a.ctx"), str(d / "b.ctx")
    assert _port(["build", "-k", "11", "-s", "A", "-1", fa_a, ca,
                  "-q"]) == 0
    assert _port(["build", "-k", "11", "-s", "B", "-1", fa_b, cb,
                  "-q"]) == 0
    reads = [a[20:90], other, b[90:170], a[5:12], a[30:60] + "NN" + a[62:99],
             random_dna(33, seed=521) + a[150:170], b[100:150]]
    mixed = str(d / "mixed.fa")
    write_fasta(mixed, reads)
    fq = str(d / "mixed.fq")
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@q{i}\n{r}\n+\n{''.join('I#5'[j % 3] for j in range(len(r)))}\n")
    m1, m2 = str(d / "m1.fa"), str(d / "m2.fa")
    write_fasta(m1, reads[:4])
    write_fasta(m2, [other, other, a[100:180], reads[5]])
    inter = str(d / "inter.fq")
    with open(fq) as src, open(inter, "w") as dst:
        dst.write(src.read())
    return dict(d=d, ctx=ctx, ca=ca, cb=cb, fa_a=fa_a, mixed=mixed, fq=fq,
                m1=m1, m2=m2, inter=inter, a=a)


READS = {
    # tests/test_commands2.py::test_reads_filter
    "seq_out": ["--seq", "MIXED", "-o", "W/kept.fa"],
    "seq_invert": ["--seq", "MIXED", "--invert", "-o", "W/kept.fa"],
    "seq_colon": ["-1", "MIXED:W/filt"],
    "fastq_in_fasta_out": ["-F", "fasta", "-1", "FQ:W/filt", "-v"],
    "fastq_out_fq": ["-1", "FQ", "-o", "W/kept.fq"],
    "seq2": ["-2", "M1:M2:W/pe"],
    "seq2_invert_fasta": ["-2", "M1:M2:W/pe", "-v", "-F", "fasta"],
    "seqi": ["-i", "INTER:W/il"],
    "all_three": ["-1", "MIXED:W/se", "-2", "M1:M2:W/pe", "-i",
                  "INTER:W/il", "-F", "FASTQ"],
    "no_input": [],
}


def _args(two_colour, work, argv):
    sub = {"MIXED": two_colour["mixed"], "FQ": two_colour["fq"],
           "M1": two_colour["m1"], "M2": two_colour["m2"],
           "INTER": two_colour["inter"], "W/": work + "/"}
    out = []
    for x in argv:
        for key, val in sub.items():
            x = x.replace(key, val)
        out.append(x)
    return out


@pytest.mark.parametrize("case", list(READS))
def test_reads_matches_mctx(capsys, two_colour, case):
    work = str(two_colour["d"] / f"reads_{case}")
    res = both(capsys, work, ["reads"] + _args(two_colour, work, READS[case])
               + [two_colour["ctx"]])
    assert_same(res, "kept")
    if case == "no_input":
        assert res[1][0] == ("exit", 2)
        return
    assert res[1][0] == 0 and res[1][1]
    m = re.search(r"kept (\d+)/(\d+) reads", res[1][3])
    assert m and 0 < int(m.group(1)) <= int(m.group(2))
    if case == "seq_out":
        kept = [ln for ln in res[1][1]["kept.fa"].decode().split("\n")
                if ln and not ln.startswith(">")]
        assert kept[0] == two_colour["a"][20:90]


def test_reads_refuses_to_overwrite(capsys, two_colour):
    """An existing output without -f: exit 1 on both, the file kept; with
    -f both overwrite it."""
    work = str(two_colour["d"] / "reads_force")
    os.makedirs(work, exist_ok=True)
    out = work + "/kept.fa"
    argv = ["reads", "--seq", two_colour["mixed"], "-o", out,
            two_colour["ctx"]]
    for run in (mctx_main, _port):
        open(out, "w").write("keep me\n")
        rc, _, err = _run(capsys, run, argv)
        assert rc == 1 and "already exists" in err
        assert open(out).read() == "keep me\n"
    res = both(capsys, work, argv[:1] + ["-f"] + argv[1:])
    (jrc, _, _, _), (trc, _, _, _) = res
    assert jrc == trc == 0
    assert open(out).read() != "keep me\n"


COVERAGE = {
    # tests/test_commands2.py::test_coverage
    "plain": ["--seq", "MIXED"],
    # tests/test_cli_flags.py::test_coverage_degree_symbols
    "degree": ["-1", "FA_A", "-E"],
    "edges_degree": ["-1", "MIXED", "-e", "-E"],
    "fastq_out": ["-s", "FQ", "-e", "-o", "W/cov.txt"],
}


@pytest.mark.parametrize("case", list(COVERAGE))
def test_coverage_matches_mctx(capsys, two_colour, case):
    work = str(two_colour["d"] / f"cov_{case}")
    argv = _args(two_colour, work, COVERAGE[case])
    argv = [x.replace("FA_A", two_colour["fa_a"]) for x in argv]
    res = both(capsys, work, ["coverage"] + argv + [two_colour["ctx"]])
    assert_same(res)
    text = res[1][2] or res[1][1]["cov.txt"].decode()
    lines = text.split("\n")
    assert lines[0].startswith(">")
    if case == "degree":
        deg = lines[3]                  # >name, 2 covg lines, degrees
        assert deg[0] == "/" and deg[-1] == "\\"


def test_coverage_of_several_graphs_matches_mctx(capsys, two_colour):
    """tests/test_cli_flags.py::test_multi_graph_inputs: one coverage
    line per colour of the graphs given, in order."""
    work = str(two_colour["d"] / "cov_multi")
    res = both(capsys, work, ["coverage", "-1", two_colour["fa_a"], "-e",
                              "-E", two_colour["ca"], two_colour["cb"]])
    assert_same(res)
    out = res[1][2].splitlines()
    assert all(c == "1" for c in out[1].split())
    # b holds a but for the kmers across its insert
    assert set(out[2].split()) == {"0", "1"}

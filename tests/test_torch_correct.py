"""Paired-end threading and read correction of the port
(mccortex_tpu_torch/links/thread.py `pair_to_rows`, `thread_reads_pe`;
align/correct.py `correct_pairs`; the commands `thread -2/-i` and
`correct`) against mccortex_tpu on the CPU, exactly (tolerance 0: every
value compared is an integer or text).

The inputs are those of tests/test_pe.py (a genome holding a repeat
longer than a read and shorter than a fragment; perfect FR pairs),
tests/test_correct.py (reads with one substitution) and
tests/test_correct_twoway.py (a pair with an error in each mate).  The
function-level cases share one k = 11 graph, built by the port, padded
to one capacity and carried into the JAX package; the commands run on
`.ctx` files the port writes (their bytes equal mctx's).  Each batch of
pairs has one shape of gaps, so JAX compiles each walker program once.
"""

import gzip
import os
import re
import time

import numpy as np
import pytest

from mccortex_tpu.align import correct as jac
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.links import thread as jth
from mccortex_tpu_torch.align import correct as tac
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.links import store as tls
from mccortex_tpu_torch.links import thread as tth

from test_ctx_io import write_fasta
from test_pe import make_pairs
from test_torch_links import (Recorder, _reads_equal, _stats_equal, graphs,
                              replay, stores_equal)
from util import random_dna, revcomp_str, seq_to_codes

K = 11
DATE = "2026-01-02 03:04:05"


def _alt(c):
    return "ACGT"[("ACGT".index(c) + 1) % 4]


def _pe_genome():
    """tests/test_pe.py::test_pe_links_resolve_long_repeat's genome."""
    rep = random_dna(60, seed=900)
    ua, ub = random_dna(80, seed=901), random_dna(80, seed=902)
    uc, ud = random_dna(80, seed=903), random_dna(80, seed=904)
    return ua + rep + ub + uc + rep + ud


PE_GENOME = _pe_genome()
TW_GENOME = random_dna(260, seed=2000)   # test_correct_twoway.py


@pytest.fixture(scope="module")
def uni():
    """Both packages' store of the PE genome and the two-way genome (k =
    11), and 64 perfect FR pairs of 40 bp with a 30 bp gap."""
    jg, tg = graphs([(PE_GENOME, 0), (TW_GENOME, 0), (TW_GENOME, 0)])
    p1, p2 = make_pairs(PE_GENOME, 64, 40, 30, seed=905)
    c1 = np.stack([seq_to_codes(s) for s in p1])
    c2 = np.stack([seq_to_codes(s) for s in p2])
    return dict(jg=jg, tg=tg, c1=c1, c2=c2)


def test_pair_to_rows_matches_jax():
    rng = np.random.default_rng(4)
    c1 = rng.integers(0, 5, (7, 13)).astype(np.uint8)
    c2 = rng.integers(0, 5, (7, 9)).astype(np.uint8)
    (got, gcol), (want, wcol) = (tth.pair_to_rows(c1, c2),
                                 jth.pair_to_rows(c1, c2))
    assert gcol == wcol == 13
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _stores_and_stats(u, one_way, links_prev, monkeypatch=None):
    kw = dict(frag_len_min=60, frag_len_max=200, one_way=one_way)
    jstats, tstats = jth.ThreadStats(1), tth.ThreadStats(1)
    ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
    rec = Recorder(monkeypatch) if monkeypatch else None
    jl = jth.thread_reads_pe(u["jg"], [(u["c1"], u["c2"], 0)], 1,
                             links_prev=links_prev[0], stats=jstats,
                             aln_stats=ja, **kw)
    if monkeypatch:
        monkeypatch.undo()
    tl = tth.thread_reads_pe(u["tg"], [(u["c1"], u["c2"], 0)], 1,
                             links_prev=links_prev[1], stats=tstats,
                             aln_stats=ta, **kw)
    stores_equal(tl, jl)
    assert tstats.contig_hists == jstats.contig_hists
    _stats_equal(ta, ja)
    return jl, ja, rec


@pytest.mark.parametrize("one_way", [True, False])
def test_thread_reads_pe_matches_jax(uni, one_way, monkeypatch):
    """The links of 64 pairs, the contig histogram and every alignment
    counter; the one-way run's walks are recorded in JAX and replayed on
    the port from the same state, every field compared."""
    jl, ja, rec = _stores_and_stats(uni, one_way, (None, None),
                                    monkeypatch if one_way else None)
    assert jl.nlinks > 0 and ja.num_ins_traversed > 0
    if one_way:
        tl_empty = tls.empty(uni["tg"].capacity, 1, device="cpu")
        assert replay(dict(tg=uni["tg"]), rec.calls, tl_empty) == \
            {"walk_linked", "forced"}
        assert rec.calls


def test_thread_reads_pe_with_links_prev_matches_jax(uni):
    """Gap walkers guided by the single-end links of the mates."""
    se = np.concatenate([uni["c1"], uni["c2"]])
    jprev = jth.thread_reads(uni["jg"], [(se, 0)], 1)
    tprev = tth.thread_reads(uni["tg"], [(se, 0)], 1)
    stores_equal(tprev, jprev)
    jl, _, _ = _stores_and_stats(uni, True, (jprev, tprev))
    assert jl.nlinks > 0


def _tw_pairs(n=4):
    """tests/test_correct_twoway.py::test_correct_pairs_fixes_both_mates,
    n times over the genome: one substitution in each mate."""
    c1, c2, r1s, r2s = [], [], [], []
    for i in range(n):
        s = 5 * i
        r1 = TW_GENOME[s:s + 80]
        r2 = revcomp_str(TW_GENOME[s + 160:s + 240])
        c1.append(seq_to_codes(r1[:40] + _alt(r1[40]) + r1[41:]))
        c2.append(seq_to_codes(r2[:30] + _alt(r2[30]) + r2[31:]))
        r1s.append(r1)
        r2s.append(r2)
    return np.stack(c1), np.stack(c2), r1s, r2s


def test_correct_pairs_matches_jax(uni):
    """Both mates of 4 pairs corrected, mate 2 back in its orientation:
    every field of every read and every counter equal to JAX's; the
    seven parts of correct_batch(..., _return_parts=True) equal too where
    a kmer is in the graph (the port's last bases are character codes
    where JAX's are 1-character strings)."""
    c1, c2, r1s, r2s = _tw_pairs()
    ja, ta = jac.CorrectAlnStats(), tac.CorrectAlnStats()
    kw = dict(frag_len_max=400)
    jm1, jm2 = jac.correct_pairs(uni["jg"], None, c1, c2, aln_stats=ja, **kw)
    tm1, tm2 = tac.correct_pairs(uni["tg"], None, c1, c2, aln_stats=ta, **kw)
    _reads_equal(tm1, jm1)
    _reads_equal(tm2, jm2)
    _stats_equal(ta, ja)
    assert [m.seq for m in tm1] == r1s and [m.seq for m in tm2] == r2s
    assert all(m.nfixed >= 1 for m in tm1 + tm2)

    rows, mate_col = tth.pair_to_rows(c1, c2)
    want = jac.correct_batch(uni["jg"], None, rows, mate_col=mate_col,
                             _return_parts=True, **kw)
    got = tac.correct_batch(uni["tg"], None, rows, mate_col=mate_col,
                            _return_parts=True, **kw)
    assert len(got) == len(want) == 7
    assert got[2] == want[2]  # runs by read
    # idx, orient and okm_all where a kmer is in the graph (elsewhere
    # they are unspecified in both packages)
    valid = np.zeros(got[0].shape, bool)
    for b, runs in enumerate(got[2]):
        for s, e in runs:
            valid[b, s:e + 1] = True
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][valid], np.asarray(want[i])[valid])
    np.testing.assert_array_equal(got[5][valid.reshape(-1)],
                                  np.asarray(want[5])[valid.reshape(-1)])
    np.testing.assert_array_equal(got[4][valid].view("S1").astype(str),
                                  np.asarray(want[4])[valid])
    assert sorted(got[3]) == sorted(want[3])
    for key, (fv, fb) in want[3].items():
        np.testing.assert_array_equal(got[3][key][0], fv)
        np.testing.assert_array_equal(got[3][key][1], fb)
    assert got[6] == want[6]


@pytest.mark.parametrize("disp", ["ACGTn", "aCGtN", "", "nnACG", "Tt"])
def test_rc_display_matches_jax(disp):
    assert tac._rc_display(disp) == jac._rc_display(disp)


# ---------------------------------------------------------------------------
# the commands against mctx
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def fixed_state(monkeypatch):
    """Both packages stamp a .ctp header through time.strftime; mctx keeps
    -O in a module global (restored after each test)."""
    from mccortex_tpu.io import seqio as jseqio
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: DATE)
    monkeypatch.setattr(jseqio, "FQ_OFFSET", jseqio.FQ_OFFSET)


def _port(argv):
    return port_main(argv + ["--device", "cpu"])


def _content(path):
    data = open(path, "rb").read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return re.sub(rb'"generator": "[^"]*"', b'"generator": "-"', data)


def _both(capsys, work, argv):
    """argv through mctx and through the port (--device cpu) with the
    same paths; each side's new files in `work` read and removed.
    Returns [(rc, {name: content}, stdout, stderr)] for (mctx, port)."""
    os.makedirs(work, exist_ok=True)
    res = []
    for run in (mctx_main, _port):
        before = set(os.listdir(work))
        capsys.readouterr()
        rc = run(argv)
        cap = capsys.readouterr()
        files = {}
        for name in sorted(set(os.listdir(work)) - before):
            files[name] = _content(os.path.join(work, name))
            os.remove(os.path.join(work, name))
        res.append((rc, files, cap.out, cap.err))
    (jrc, jf, jout, jerr), (trc, tf, tout, terr) = res
    assert jrc == trc == 0
    assert sorted(tf) == sorted(jf) and tf == jf
    assert tout == jout
    keep = ("threaded", "[CorrectAln]", "zeroing", "corrected")
    status = [[ln for ln in e.splitlines() if ln.startswith(
        tuple("[mctx] " + p for p in keep))] for e in (jerr, terr)]
    assert status[1] == status[0]
    return tf, terr


def _write_fastq(path, seqs):
    """Quality 40 everywhere but at base 60 (where the reads of
    `correct_files` carry their substitution): 2."""
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            q = "".join("#" if j == 60 else "I" for j in range(len(s)))
            fh.write(f"@r{i}\n{s}\n+\n{q}\n")


@pytest.fixture(scope="module")
def pe_files(tmp_path_factory):
    """tests/test_pe.py::test_cli_thread_pe's 150 FR pairs of 50 bp with a
    40 bp gap, drawn from the repeat genome of test_pe.py (so that the
    pairs make links), as two FASTA files and interleaved FASTQ; the
    graph of the genome (k = 11); single-end links of the mates."""
    d = tmp_path_factory.mktemp("pe_cmd")
    genome = PE_GENOME
    p1, p2 = make_pairs(genome, 150, 50, 40, seed=911)
    f = {n: str(d / n) for n in ("g.fa", "r1.fa", "r2.fa", "il.fq", "g.ctx",
                                 "se.ctp.gz")}
    write_fasta(f["g.fa"], [genome])
    write_fasta(f["r1.fa"], p1)
    write_fasta(f["r2.fa"], p2)
    _write_fastq(f["il.fq"], [s for pair in zip(p1, p2) for s in pair])
    assert _port(["build", "-k", str(K), "--sample", "s", "--seq", f["g.fa"],
                  f["g.ctx"], "-q"]) == 0
    assert _port(["thread", "--no-gap-fill", "--seq", f["r1.fa"], "--seq",
                  f["r2.fa"], "-o", f["se.ctp.gz"], f["g.ctx"], "-q"]) == 0
    f["d"] = d
    return f


THREAD_PE = {
    # '-2 A B', with the gap and fragment histograms
    "seq2": ["-2", "R1", "R2", "-g", "W/gaps.csv", "-G", "W/frag.csv"],
    # the reference's '-2 A:B', two-way, a minimum fragment length
    "seq2_colon_two_way": ["-2", "R1:R2", "-W", "-l", "100"],
    # interleaved pairs in a FASTQ file, mates given as RF then read FR
    "seqi": ["-i", "IL", "-M", "FR", "-L", "1000"],
    # single reads and pairs in one run, their links merged
    "seq_and_seq2": ["--seq", "R1", "-2", "R1", "R2"],
    # pairs guided by loaded links, -0 zeroing their counts
    "seq2_paths_zero": ["-2", "R1", "R2", "-p", "SE", "-0"],
    # pairs with no gap filling of single reads (the pairs still bridge)
    "seqi_no_gap_fill": ["--no-gap-fill", "-i", "IL", "-2", "R1", "R2"],
}


@pytest.mark.parametrize("case", list(THREAD_PE))
def test_thread_pe_matches_mctx(capsys, pe_files, case):
    work = str(pe_files["d"] / f"thread_{case}")
    sub = {"R1": pe_files["r1.fa"], "R2": pe_files["r2.fa"],
           "IL": pe_files["il.fq"], "SE": pe_files["se.ctp.gz"]}
    args = []
    for x in THREAD_PE[case]:
        x = x.replace("W/", work + "/")
        args.append(":".join(sub.get(p, p) for p in x.split(":")))
    files, err = _both(capsys, work, ["thread"] + args
                       + ["-o", work + "/pe.ctp.gz", pe_files["g.ctx"]])
    m = re.search(r"threaded (\d+) reads \+ (\d+) pairs -> (\d+) links", err)
    assert m and int(m.group(3)) > 0
    npairs = {"seq2": 150, "seq2_colon_two_way": 150, "seqi": 0,
              "seq_and_seq2": 150, "seq2_paths_zero": 150,
              "seqi_no_gap_fill": 150}[case]
    assert int(m.group(2)) == npairs
    assert "num_paths" in files["pe.ctp.gz"].decode()
    if case == "seq2":
        assert len(files["frag.csv"].splitlines()) > 100


@pytest.fixture(scope="module")
def correct_files(tmp_path_factory):
    """tests/test_correct.py::test_cli_correct (a 250 bp genome seen 3x,
    reads with one substitution) and test_correct_twoway.py::
    test_cli_correct_seq2 (a 260 bp genome seen 2x, pairs with an error
    in mate 1) in one graph (k = 11); links of the clean reads."""
    d = tmp_path_factory.mktemp("correct_cmd")
    g1 = random_dna(250, seed=740)
    g2 = random_dna(260, seed=2100)
    f = {n: str(d / n) for n in ("good.fa", "bad.fa", "bad.fq", "p1.fa",
                                 "p2.fa", "il.fa", "g.ctx", "l.ctp.gz")}
    write_fasta(f["good.fa"], [g1] * 3 + [g2] * 2)
    bad = [g1[s:s + 150] for s in (0, 20, 50, 100)]
    bad = [r[:60] + _alt(r[60]) + r[61:] for r in bad]
    write_fasta(f["bad.fa"], bad)
    _write_fastq(f["bad.fq"], bad + [g1[30:100]])
    p1, p2 = [], []
    for s in (0, 5, 10):
        r1 = g2[s:s + 80]
        p1.append(r1[:40] + _alt(r1[40]) + r1[41:])
        p2.append(revcomp_str(g2[s + 160:s + 240]))
    write_fasta(f["p1.fa"], p1)
    write_fasta(f["p2.fa"], p2)
    write_fasta(f["il.fa"], [s for pair in zip(p1, p2) for s in pair])
    assert _port(["build", "-k", str(K), "--sample", "s", "--seq",
                  f["good.fa"], f["g.ctx"], "-q"]) == 0
    assert _port(["thread", "--seq", f["good.fa"], "-o", f["l.ctp.gz"],
                  f["g.ctx"], "-q"]) == 0
    f["d"], f["g1"], f["g2"] = d, g1, g2
    return f


CORRECT = {
    # <in>:<out> -> <out>.fa.gz, with -P and the histograms
    "seq_colon": ["-1", "BAD:W/fixed", "-P", "-C", "W/contig.csv", "-g",
                  "W/gaps.csv"],
    # FASTQ in and out, masks, gap model and context options
    "seq_fastq_masks": ["-1", "BADQ", "-o", "W/fixed.fq", "-F", "fastq",
                        "-Q", "20", "-O", "33", "-H", "6", "-X", "30", "-d",
                        "3", "-D", "0.2", "-E", "-Z", "5"],
    # '-2 A B -o' (interleaved output) and the fragment histogram
    "seq2_out": ["--seq2", "P1", "P2", "-o", "W/fixed.fa", "-L", "400",
                 "-G", "W/frag.csv"],
    # '-2 A:B:O' (two files), FASTQ, two-way, links
    "seq2_colon": ["-2", "P1:P2:W/pe", "-F", "fastq", "-W", "-p", "LINKS",
                   "-L", "400"],
    # interleaved, '<in>:<out>' and plain with -o
    "seqi_colon": ["-i", "IL:W/il", "-l", "10", "-L", "400", "-M", "FR",
                   "-e", "-c", "0", "-w"],
    "seqi_out": ["-i", "IL", "-o", "W/il.fa", "-L", "400", "-P"],
}


@pytest.mark.parametrize("case", list(CORRECT))
def test_correct_matches_mctx(capsys, correct_files, case):
    f = correct_files
    work = str(f["d"] / f"correct_{case}")
    sub = {"BAD": f["bad.fa"], "BADQ": f["bad.fq"], "P1": f["p1.fa"],
           "P2": f["p2.fa"], "IL": f["il.fa"], "LINKS": f["l.ctp.gz"]}
    args = []
    for x in CORRECT[case]:
        x = x.replace("W/", work + "/")
        args.append(":".join(sub.get(p, p) for p in x.split(":")))
    files, err = _both(capsys, work, ["correct"] + args + [f["g.ctx"]])
    m = re.search(r"corrected (\d+) reads: (\d+)/(\d+) gaps bridged", err)
    assert m and int(m.group(2)) > 0
    seqs = [ln for name, data in files.items()
            if not name.endswith(".csv")
            for ln in data.decode().split("\n")[1::2 if ".fq" not in name
                                                else 4]]
    assert f["g1"][:150] in seqs or f["g2"][:80] in seqs

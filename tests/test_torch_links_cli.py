"""`mctx-torch thread`, `contigs -p [-P -C -T]` and `check -p` against
`mctx` on the CPU: the same .ctp text (decompressed, the date fixed, only
the header's `generator` masked), the same FASTA and CSV bytes, the same
status lines and exit codes; with --devices 2 the one-device bytes.

The data: a 1.4 kb genome holding a 50 bp repeat three times and a
30 bp one twice, its error-free
reads (the graph, k = 11) and reads of it with substitutions of low
quality (threaded: each substitution is a gap to fill).  The walks of
`contigs -p` with the missing-information check, the confidence model
and used-link marking are recorded in mctx and replayed on the port from
the same states, every field compared.
"""

import gzip
import os
import re
import time

import numpy as np
import pytest

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu_torch.cli.commands import _load_graph as tload
from mccortex_tpu_torch import native as tnative
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.io import ctp as tctp
from mccortex_tpu_torch.utils import timing

from test_torch_links import Recorder, replay

K = 11
DATE = "2026-01-02 03:04:05"


@pytest.fixture(autouse=True)
def fixed_date(monkeypatch):
    """Both packages stamp the .ctp header through time.strftime."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: DATE)


def _write_fastq(path, reads, quals):
    with open(path, "w") as fh:
        for i, (r, q) in enumerate(zip(reads, quals)):
            fh.write(f"@r{i}\n{r}\n+\n{q}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("links_cli")
    rng = np.random.default_rng(21)

    def dna(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    rep, rep2 = dna(50), dna(30)
    genome = (dna(150) + rep + dna(200) + rep2 + dna(150) + rep + dna(200)
              + rep2 + dna(150) + rep + dna(150))
    starts = list(range(0, len(genome) - 100 + 1, 9))
    clean = [genome[s:s + 100] for s in starts]
    fa = str(d / "clean.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(clean):
            fh.write(f">c{i}\n{r}\n")
    reads, quals = [], []
    for r in clean * 2:
        b = list(r)
        q = ["I"] * len(b)
        for pos in np.nonzero(rng.random(len(b)) < 0.01)[0]:
            b[pos] = "ACGT"[("ACGT".index(b[pos]) + 1) % 4]
            q[pos] = "#"
        if rng.random() < 0.05:
            b[40:43] = "NNN"
        reads.append("".join(b))
        quals.append("".join(q))
    fq = str(d / "reads.fq")
    _write_fastq(fq, reads, quals)
    ctx = str(d / "g.ctx")
    assert port_main(["build", "-k", str(K), "-s", "s0", "--seq", fa, ctx,
                      "-q", "--device", "cpu"]) == 0
    # contigs seeds: 8 kmers spread over the genome (one walker batch)
    seeds = str(d / "seeds.fa")
    with open(seeds, "w") as fh:
        for i, s in enumerate(range(0, len(genome) - K, len(genome) // 8)):
            fh.write(f">s{i}\n{genome[s:s + K]}\n")
    return dict(d=d, fq=fq, ctx=ctx, genome=genome, n=len(reads),
                seeds=seeds)


def _masked(text):
    return re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)


def _text(path):
    """Decompressed .ctp text, the generator value masked."""
    masked = _masked(gzip.open(path, "rt").read())
    assert masked.count('"generator": "-"') == 1
    return masked


def _status(err, *prefixes):
    return [line for line in err.splitlines()
            if line.startswith(tuple("[mctx] " + p for p in prefixes))]


def _both(capsys, data, argv, outs, tag):
    """argv through mctx and through the port (--device cpu), with the
    same output paths (OUTn; a .ctp header records
    the command line), each side's outputs then moved aside; returns
    [(files, stdout, stderr, rc)] for (mctx, port)."""
    res = []
    paths = [str(data["d"] / f"{tag}_{i}_{o}") for i, o in enumerate(outs)]
    a = [paths[int(x[3:])] if x.startswith("OUT") else x for x in argv]
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        capsys.readouterr()
        rc = run(a)
        cap = capsys.readouterr()
        moved = [f"{p}.{side}" for p in paths]
        for p, m in zip(paths, moved):
            if os.path.exists(p):
                os.replace(p, m)
        res.append((moved, cap.out, cap.err, rc))
    return res


THREAD = {
    "default": ["-g", "OUT1", "-G", "OUT2"],
    "no_gap_fill": ["--no-gap-fill", "-x", "-y", "-z"],
    "two_way": ["-W"],
    "use_new_paths": ["-u", "-O", "33"],
    "masks_and_gap_model": ["-Q", "20", "-H", "4", "-E", "-X", "30", "-d",
                            "3", "-D", "0.2"],
    "se_mate_flags": ["-L", "500", "-l", "10", "-M", "RF", "-w"],
    "paths_zero": ["-p", "PREV", "-0"],
}


def _thread(capsys, data, case, monkeypatch):
    # mctx keeps -O in a module global: restored after the test
    from mccortex_tpu.io import seqio as jseqio
    monkeypatch.setattr(jseqio, "FQ_OFFSET", jseqio.FQ_OFFSET)
    argv = list(THREAD[case])
    if "PREV" in argv:
        argv[argv.index("PREV")] = _prev_links(capsys, data)
    outs = ["links.ctp.gz", "gaps.csv", "frag.csv"]
    return _both(capsys, data, ["thread", "--seq", data["fq"], "-o", "OUT0"]
                 + argv + [data["ctx"]], outs, "thread_" + case)


def _prev_links(capsys, data):
    """mctx's --no-gap-fill links of the reads (the -p input)."""
    if "prev" not in data:
        path = str(data["d"] / "prev.ctp.gz")
        assert mctx_main(["thread", "--no-gap-fill", "--seq", data["fq"],
                          "-o", path, data["ctx"]]) == 0
        capsys.readouterr()
        data["prev"] = path
    return data["prev"]


# every case reads through the C++ parser; with and without gap filling,
# and with -Q, also through the Python one: the same .ctp bytes
THREAD_READERS = [pytest.param(c, "native", id=c) for c in THREAD] + [
    pytest.param(c, "python", id=f"{c}-python")
    for c in ("no_gap_fill", "masks_and_gap_model")]


@pytest.mark.parametrize("case,reader", THREAD_READERS)
def test_thread_matches_mctx(capsys, data, case, reader, monkeypatch):
    if reader == "python":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    (jp, jout, jerr, jrc), (tp, tout, terr, trc) = _thread(capsys, data, case,
                                                           monkeypatch)
    assert timing.COUNTERS[f"read.{reader}"] == data["n"]
    assert jrc == trc == 0
    assert _text(tp[0]) == _text(jp[0])
    for j, t in zip(jp[1:], tp[1:]):
        assert os.path.exists(j) == os.path.exists(t)
        if os.path.exists(j):
            assert open(t).read() == open(j).read()
    assert _masked(tout) == _masked(jout)
    keep = ("threaded", "[CorrectAln]", "zeroing")
    assert _status(terr, *keep) == _status(jerr, *keep)
    m = re.search(r"threaded (\d+) reads \+ 0 pairs -> (\d+) links", jerr)
    assert m and int(m.group(1)) == data["n"] and int(m.group(2)) > 5
    if case != "no_gap_fill":
        assert re.search(r"\[CorrectAln\] gaps attempted [1-9]", terr)
    if case == "no_gap_fill":
        assert "contig[0]: " in tout and "read: " in tout


CONTIGS = {
    # the walk with the missing-information check (the default)
    "p": [],
    # the other options of the linked walker: used-link marking and the
    # second pass from unused links, the confidence model's halts and
    # headers, its table as CSV (-M: one JAX compile less)
    "p_P_C_T": ["-P", "-C", "0.3", "-T", "0.6", "-G", "1000",
                "-S", "OUT1", "-M"],
}


@pytest.mark.parametrize("case", list(CONTIGS))
def test_contigs_p_matches_mctx(capsys, data, case, monkeypatch):
    """contigs -p from 8 seed kmers (one batch): the same FASTA bytes
    (and confidence CSV) and status lines; every walk of mctx's run
    replayed on the port from the same state."""
    links = _prev_links(capsys, data)
    # --max-len 2047: longer than any walk of the 1.4 kb genome, so no hop
    # is cut short (mctx's clipped hops are a reference fault, ROADMAP.md
    # Queue 3); mctx's second pass walks chunks of 512 steps, so one chunk
    # size (one JAX compile) covers its max_len + 1
    argv = (["contigs", "-p", links, "-s", data["seeds"], "--max-len",
             "2047", "-o", "OUT0"] + CONTIGS[case] + [data["ctx"]])
    rec = Recorder(monkeypatch)
    res = _both(capsys, data, argv, ["contigs.fa", "conf.csv"],
                "contigs_" + case)
    monkeypatch.undo()
    (jp, _jo, jerr, jrc), (tp, _to, terr, trc) = res
    assert jrc == trc == 0
    for j, t in zip(jp, tp):
        assert os.path.exists(j) == os.path.exists(t)
        if os.path.exists(j):
            assert open(t).read() == open(j).read()
    keep = ("contigs", "saved")
    assert _status(terr, *keep) == _status(jerr, *keep)
    fa = open(tp[0]).read()
    best = max(fa.split("\n")[1::2], key=len)
    assert len(best) > 300 and (best in data["genome"] or best[::-1].translate(
        str.maketrans("ACGT", "TGCA")) in data["genome"])
    if case == "p_P_C_T":
        assert " lf.conf=" in fa and "seeding from" in terr
        assert "seedpath=" in fa
    # the recorded walks of mctx, replayed on the port
    u = dict(tg=tload(data["ctx"], "cpu")[1])
    tl = tctp.load_link_store([links], u["tg"])
    seen = replay(u, rec.calls, tl)
    want = {"walk_linked", "walk_along", "hopinfo"}
    want |= ({"conf_table", "track_used"} if case == "p_P_C_T"
             else {"missing_check"})
    assert seen == want


def test_check_p_matches_mctx(capsys, data):
    """check -p on the reads' links: the same exit code and status (a
    corrupted store: tests/test_torch_links.py)."""
    links = _prev_links(capsys, data)
    (_, _, jerr, jrc), (_, _, terr, trc) = _both(
        capsys, data, ["check", "-p", links, data["ctx"]], [], "check")
    assert jrc == trc == 0
    want = [line for line in jerr.splitlines() if "links OK" in line]
    assert [line for line in terr.splitlines() if "links OK" in line] == want
    assert len(want) == 1


DEVICES = {
    # gap-filled threading runs on one device, as in mctx
    "thread_devices": ["thread", "--seq", "FQ", "-o", "OUT"],
    # the linked walk runs on one device, as in mctx
    "contigs_devices": ["contigs", "-p", "PREV", "-s", "SEEDS",
                        "--max-len", "2047", "-o", "OUT"],
}


@pytest.mark.parametrize("case", list(DEVICES))
def test_devices_2_writes_the_one_device_bytes(capsys, data, case):
    """--devices 2 on the CPU: the same .ctp text (less the recorded
    flag) or FASTA bytes as the one-device run, to the same path."""
    out = str(data["d"] / f"{case}.out")
    subst = {"FQ": data["fq"], "OUT": out, "SEEDS": data["seeds"]}
    if "PREV" in DEVICES[case]:
        subst["PREV"] = _prev_links(capsys, data)
    argv = [subst.get(a, a) for a in DEVICES[case]] + [data["ctx"]]
    got = []
    for extra in ([], ["--devices", "2"]):
        capsys.readouterr()
        assert port_main(argv + extra + ["--device", "cpu", "-f"]) == 0
        err = capsys.readouterr().err
        got.append(_text(out).replace(" --devices 2", "")
                   if case == "thread_devices" else open(out).read())
    assert got[0] == got[1] and len(got[0]) > 100
    assert ("runs single-device" in err if case == "thread_devices"
            else "walkers sharded over 2 devices" in err)

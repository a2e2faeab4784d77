"""The rest of `mctx-torch build` against `mctx build` on the CPU: mate
pairs (--seq2, --seqi, -M), PCR duplicate removal (-p), --graph,
--intersect, -m, -n and the sort engines.  The paired readers and the
PCR filter are held against the JAX package's on the same batches; the
commands must write the same .ctx bytes.  Exact equality, no
tolerance."""

import numpy as np
import pytest
import torch

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import build as jb
from mccortex_tpu.io import seqio as jseqio
from mccortex_tpu_torch.cli import common as tcommon
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.io import ctx as tctx
from mccortex_tpu_torch.io import seqio as tseqio
from mccortex_tpu_torch.utils import membudget as tmb

K = 11


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Mate pairs from a small genome, with duplicate pairs, half
    duplicates, a read with an N and reads shorter than k; as two FASTQ
    files, one interleaved FASTA and one single-end FASTA."""
    d = tmp_path_factory.mktemp("flags")
    rng = np.random.default_rng(77)
    genome = _dna(rng, 900)
    pairs = []
    for _ in range(60):
        s = int(rng.integers(0, 900 - 160))
        pairs.append((genome[s:s + 50], _rc(genome[s + 90:s + 150])))
    pairs += [pairs[3], pairs[7], pairs[3]]                # duplicate pairs
    pairs.append((pairs[5][0], _rc(genome[10:60])))        # half duplicate
    pairs.append(("ACGTN" + genome[5:40], pairs[9][1]))    # N in the start
    pairs.append((genome[100:108], genome[200:260]))       # shorter than k
    order = rng.permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    f1, f2, fi, fs = (str(d / n) for n in ("r1.fq", "r2.fq", "il.fa", "se.fa"))
    with open(f1, "w") as a, open(f2, "w") as b, open(fi, "w") as c:
        for i, (x, y) in enumerate(pairs):
            qx = "".join(chr(33 + int(v)) for v in rng.integers(2, 41, len(x)))
            qy = "".join(chr(33 + int(v)) for v in rng.integers(2, 41, len(y)))
            a.write(f"@p{i}/1\n{x}\n+\n{qx}\n")
            b.write(f"@p{i}/2\n{y}\n+\n{qy}\n")
            c.write(f">p{i}/1\n{x}\n>p{i}/2\n{y}\n")
    with open(fs, "w") as f:
        for i, (x, _y) in enumerate(pairs):
            f.write(f">s{i}\n{x}\n")
        f.write(f">long\n{genome}\n")
    other = _dna(rng, 300) + genome[200:500]
    fo = str(d / "other.fa")
    with open(fo, "w") as f:
        f.write(f">o\n{other}\n")
    return dict(dir=d, f1=f1, f2=f2, fi=fi, fs=fs, fo=fo)


def _same_ctx(tmp_path, args, port_extra=(), name="x"):
    """Run `mctx build` and `mctx-torch build --device cpu` with the same
    arguments; the two .ctx files must be equal byte for byte."""
    a, b = tmp_path / f"{name}_mctx.ctx", tmp_path / f"{name}_port.ctx"
    assert mctx_main(["build", "-k", str(K)] + args + ["-q", str(a)]) == 0
    assert port_main(["build", "-k", str(K)] + args + list(port_extra)
                     + ["-q", "--device", "cpu", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    return b


# ---------------------------------------------------------------------------
# readers and the PCR filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matedir", ["FR", "FF", "RF", "RR"])
def test_mate_normalize_matches_jax(matedir):
    rng = np.random.default_rng(5)
    c1 = rng.integers(0, 5, size=(6, 20)).astype(np.uint8)
    c2 = rng.integers(0, 5, size=(6, 20)).astype(np.uint8)
    q1 = rng.integers(0, 41, size=(6, 20)).astype(np.uint8)
    q2 = rng.integers(0, 41, size=(6, 20)).astype(np.uint8)
    for args in ((c1, c2, matedir), (c1, c2, matedir, q1, q2),
                 (c1, c2, matedir, None, q2)):
        want = jseqio.mate_normalize(*args)
        got = tseqio.mate_normalize(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tseqio.mate_normalize(c1, c2, "XX")


@pytest.mark.parametrize("matedir", ["FR", "FF"])
def test_paired_readers_match_jax(inputs, matedir):
    # few batches: the JAX reader's bounded prefetch queue loses its
    # end marker when the queue is full at the end of the file
    want = list(jseqio.read_batches_pe(inputs["f1"], inputs["f2"], 32,
                                       colour=2, matedir=matedir))
    got = list(tseqio.read_batches_pe(inputs["f1"], inputs["f2"], 32,
                                      colour=2, matedir=matedir))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] == 2
    want = list(jseqio.read_batches_interleaved(inputs["fi"], 64,
                                                matedir=matedir))
    got = list(tseqio.read_batches_interleaved(inputs["fi"], 64,
                                               matedir=matedir))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for x, y in zip(g[:4], w[:4]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="misalign"):
        list(tseqio.read_batches_pe(inputs["f1"], inputs["f2"], max_len=40))
    with pytest.raises(ValueError, match="misalign"):
        list(tseqio.read_batches_interleaved(inputs["fi"], max_len=40))


def _pcr_batches(rng, k, n_batches, B, L):
    pool = rng.integers(0, 4, size=(12, L)).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        b = pool[rng.integers(0, len(pool), B)].copy()
        fresh = rng.random(B) < 0.4
        b[fresh] = rng.integers(0, 4, size=(int(fresh.sum()), L))
        b[rng.random(B) < 0.1, rng.integers(0, k)] = 4     # N in the start
        rc = rng.random(B) < 0.3                           # other strand
        b[rc] = (3 - b[rc])[:, ::-1]
        out.append(b)
    return out


@pytest.mark.parametrize("k", [11, 33])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_pcr_dup_filter_matches_jax(k, paired):
    rng = np.random.default_rng(k + paired)
    b1 = _pcr_batches(rng, k, 5, 40, k + 9)
    b2 = _pcr_batches(rng, k, 5, 40, k + 9) if paired else [None] * 5
    jf, tf = jb.PcrDupFilter(k), tb.PcrDupFilter(k, "cpu")
    dropped = 0
    for x, y in zip(b1, b2):
        want = jf.filter_batch(x, y)
        got = tf.filter_batch(x, y)
        np.testing.assert_array_equal(got, want)
        dropped += int((~got).sum())
    assert dropped > 0
    # the state belongs to the instance: a fresh filter starts empty
    fresh = tb.PcrDupFilter(k, "cpu").filter_batch(b1[-1], b2[-1])
    assert fresh.sum() > tf.filter_batch(b1[-1], b2[-1]).sum()
    short = np.zeros((3, k - 1), np.uint8)
    assert tb.PcrDupFilter(k, "cpu").filter_batch(short).all()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["colon", "two_args", "RF_p"])
def test_cli_seq2_matches_mctx(tmp_path, inputs, form):
    pair = [inputs["f1"] + ":" + inputs["f2"]] if form == "colon" \
        else [inputs["f1"], inputs["f2"]]
    args = ["--sample", "pe", "--seq2"] + pair
    if form == "RF_p":
        args = ["-M", "RF", "-p"] + args
    _same_ctx(tmp_path, args)


@pytest.mark.parametrize("engine", ["lax", "mp", "bitonic"])
def test_cli_seqi_pcr_matches_mctx_under_each_engine(tmp_path, inputs,
                                                     monkeypatch, capsys,
                                                     engine):
    monkeypatch.setattr(tb, "SORT_IMPL", engine)
    args = ["--sample", "il", "-p", "--seqi", inputs["fi"]]
    out = _same_ctx(tmp_path, args, name=engine)
    # the paired files hold the same mates: the same graph
    out2 = tmp_path / "pe.ctx"
    assert port_main(["build", "-k", str(K), "--sample", "il", "-p", "--seq2",
                      inputs["f1"], inputs["f2"], "--device", "cpu",
                      str(out2)]) == 0
    assert out.read_bytes() == out2.read_bytes()
    err = capsys.readouterr().err
    jf, ndup = jb.PcrDupFilter(K), 0
    for c1, c2, *_ in jseqio.read_batches_interleaved(inputs["fi"]):
        ndup += 2 * int((~jf.filter_batch(c1, c2)).sum())
    assert ndup >= 6                                   # three planted pairs
    assert f"removed {ndup} PCR duplicate reads" in err
    assert f"sort engine {engine}" in err


def test_cli_single_end_pcr_and_keep_pcr(tmp_path, inputs, capsys):
    _same_ctx(tmp_path, ["--sample", "se", "-p", "--seq", inputs["fs"]])
    _same_ctx(tmp_path, ["--sample", "se", "-P", "--sort", "-t", "2",
                         "--seq", inputs["fs"]], name="keep")
    with pytest.raises(SystemExit):
        port_main(["build", "-k", str(K), "--sample", "s", "-p", "-P",
                   "--seq", inputs["fs"], "--device", "cpu",
                   str(tmp_path / "no.ctx")])
    assert "conflicts" in capsys.readouterr().err


def test_cli_graph_input_colours_match_mctx(tmp_path, inputs):
    first = _same_ctx(tmp_path, ["-s", "A", "-1", inputs["fs"]], name="a")
    # a graph before and after a sample, and mate pairs with -p beside it
    both = _same_ctx(tmp_path, ["-g", str(first), "-s", "B", "-1",
                                inputs["fo"], "--graph", str(first)],
                     name="gbg")
    h, keys, covg, _ = tctx.read_ctx(str(both))
    assert h.ncols == 3
    assert [g.sample_name for g in h.ginfo] == ["A", "B", "A"]
    np.testing.assert_array_equal(covg[:, 0], covg[:, 2])
    assert (covg[:, 1] > 0).any() and (covg[:, 0] > 0).any()
    _same_ctx(tmp_path, ["-s", "P", "-p", "--seq2", inputs["f1"],
                         inputs["f2"], "-g", str(first)], name="pg")


def test_cli_intersect_matches_mctx(tmp_path, inputs):
    other = _same_ctx(tmp_path, ["-s", "O", "-1", inputs["fo"]], name="o")
    full = _same_ctx(tmp_path, ["-s", "A", "-1", inputs["fs"]], name="full")
    out = _same_ctx(tmp_path, ["-s", "A", "--intersect", str(other), "-1",
                               inputs["fs"]], name="isect")
    h, keys, covg, _ = tctx.read_ctx(str(out))
    _, okeys, _, _ = tctx.read_ctx(str(other))
    _, fkeys, fcovg, _ = tctx.read_ctx(str(full))
    shared = np.isin(fkeys[:, 0], okeys[:, 0])
    assert 0 < shared.sum() < len(fkeys)
    np.testing.assert_array_equal(keys, fkeys[shared])
    np.testing.assert_array_equal(covg, fcovg[shared])
    assert h.ginfo[0].cleaning.is_graph_intersection
    assert h.ginfo[0].cleaning.intersection_name == str(other)


def test_cli_memory_and_nkmers_match_mctx(tmp_path, inputs, capsys):
    _same_ctx(tmp_path, ["-s", "A", "-m", "1G", "-n", "4K", "-1",
                         inputs["fs"]])
    assert port_main(["build", "-k", str(K), "-s", "A", "-m", "1G", "-1",
                      inputs["fs"], "--device", "cpu",
                      str(tmp_path / "m.ctx")]) == 0
    err = capsys.readouterr().err
    assert "memory budget 1.0GB" in err and "memory plan: graph" in err
    # a budget the graph does not fit fails, as in mctx
    for main in (mctx_main, port_main):
        dev = ["--device", "cpu"] if main is port_main else []
        with pytest.raises(MemoryError, match="budget is 1.0KB"):
            main(["build", "-k", str(K), "-s", "A", "-m", "1K", "-1",
                  inputs["fs"], "-f", str(tmp_path / "small.ctx")] + dev)
        assert not (tmp_path / "small.ctx").exists()


def test_size_and_budget_helpers_match_jax():
    from mccortex_tpu.cli import common as jcommon
    from mccortex_tpu.utils import membudget as jmb
    for s in ("20M", "8G", "1T", "4096", "1.5k", None):
        assert tcommon.parse_size(s) == jcommon.parse_size(s)
    with pytest.raises(ValueError):
        tcommon.parse_size("lots")
    for s in ("8G", "500M", "4GB", "1024", " 2.5 kB "):
        assert tmb.parse_mem(s) == jmb.parse_mem(s)
    for n in (5, 3 << 10, 7 << 20, 9 << 30):
        assert tmb.mem_str(n) == jmb.mem_str(n)
    assert tmb.graph_mem_bytes(1000, 2, 3) == jmb.graph_mem_bytes(1000, 2, 3)
    assert tmb.kmers_in_budget(1 << 20, 2, 3) == \
        jmb.kmers_in_budget(1 << 20, 2, 3)
    assert tmb.check_plan(1 << 20, 1000) == jmb.check_plan(1 << 20, 1000)
    with pytest.raises(MemoryError):
        tmb.check_plan(10, 1000)
    assert tmb.device_mem_bytes("cpu") is None


def test_build_capacity_hint_pads_and_never_truncates():
    rng = np.random.default_rng(1)
    bases = rng.integers(0, 4, size=(8, 40)).astype(np.uint8)
    g0 = tb.build([(bases, 0)], K, device="cpu")
    big = tb.build([(bases, 0)], K, device="cpu", capacity=g0.n + 100)
    small = tb.build([(bases, 0)], K, device="cpu", capacity=3)
    assert big.capacity == g0.n + 100 and big.n == small.n == g0.n
    assert torch.equal(big.keys[:g0.n], g0.keys[:g0.n])
    assert (big.keys[g0.n:] == -1).all() and (big.covg[g0.n:] == 0).all()
    assert small.capacity == g0.n
    assert tb.build([], K, device="cpu", capacity=16).capacity == 16


@pytest.mark.parametrize("flag", [["--seq2", "only_one.fq"], ["--seqi"],
                                  ["-g"], ["-1", "x.fa"]])
def test_cli_task_arguments_are_checked(tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["build", "-k", str(K), "--device", "cpu", "-o",
                   str(tmp_path / "o.ctx")] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "needs" in err or "give --sample first" in err

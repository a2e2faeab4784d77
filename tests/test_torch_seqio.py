"""The port's ingest (mccortex_tpu_torch.io.seqio, .io.cram, .native)
against mccortex_tpu's on the CPU: the native reader and the Python
reader of the port give the batches of mccortex_tpu.io.seqio.
read_batches_native on FASTA, FASTQ (+33, +64, a forced offset), gzip,
SAM, BAM and CRAM, and those of its read_batches (whole records, batches
across files) likewise; `mctx-torch build --device cpu` writes the .ctx
bytes of `mctx build` from each format; the prefetch thread keeps its
end marker and stops when its generator is abandoned.  Exact equality,
no tolerance."""

import gzip
import struct
import threading
import time

import numpy as np
import pytest

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.io import cram as jcram
from mccortex_tpu.io import seqio as jseqio
from mccortex_tpu_torch import native as tnative
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.io import cram as tcram
from mccortex_tpu_torch.io import ctx as tctx
from mccortex_tpu_torch.io import seqio as tseqio
from mccortex_tpu_torch.utils import timing

from test_cram import _craft_mapped_cram
from test_sam_bam import write_bam, write_sam

K = 11
MAX_LEN = 256      # rows of the batch comparisons: the long record splits


def _dna(rng, n, n_frac=0.0):
    return "".join("ACGTN"[i] for i in rng.choice(
        5, n, p=[(1 - n_frac) / 4] * 4 + [n_frac]))


def _quals(rng, n, offset, lo=2, hi=41):
    return "".join(chr(offset + int(v)) for v in rng.integers(lo, hi, n))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One small input of each format and case, from a seeded genome."""
    d = tmp_path_factory.mktemp("seqio")
    rng = np.random.default_rng(31)
    genome = _dna(rng, 2000)
    reads = []
    for i in range(150):
        s = int(rng.integers(0, len(genome) - 200))
        n = int(rng.integers(60, 201))
        r = list(genome[s:s + n])
        for j in rng.integers(0, n, 2):
            r[j] = "ACGTN"[int(rng.integers(0, 5))]
        reads.append("".join(r))
    f = {}
    f["fa"] = str(d / "r.fa")
    with open(f["fa"], "w") as fh:
        for i, r in enumerate(reads[:40]):
            fh.write(f">r{i} some description\n")
            for j in range(0, len(r), 60):          # multi-line records
                fh.write((r[j:j + 60].lower() if i % 7 == 3 else
                          r[j:j + 60]) + "\n")
        fh.write(">empty\n")                        # no bases: no row
        fh.write(">long\n")                         # longer than MAX_LEN
        for j in range(0, 700, 70):
            fh.write(genome[j:j + 70] + "\n")
    for name, offset in (("fq33", 33), ("fq64", 64)):
        f[name] = str(d / f"{name}.fq")
        with open(f[name], "w") as fh:
            for i, r in enumerate(reads):
                fh.write(f"@q{i}/1\n{r}\n+\n{_quals(rng, len(r), offset)}\n")
    f["fqgz"] = str(d / "r.fq.gz")
    with gzip.open(f["fqgz"], "wt") as fh:
        for i, r in enumerate(reads[:90]):
            fh.write(f"@g{i}\n{r}\n+\n{_quals(rng, len(r), 33)}\n")
    f["zeroq"] = str(d / "zero.fq")       # every quality '!' = phred 0
    with open(f["zeroq"], "w") as fh:
        for i in range(20):
            fh.write(f"@z{i}\n{_dna(rng, 60)}\n+\n{'!' * 60}\n")
    # line ends and blanks, IUPAC and lower case, qualities shorter than
    # their read, an empty record: the Python reader's rules
    f["odd_fq"] = str(d / "odd.fq")
    with open(f["odd_fq"], "w", newline="") as fh:
        for i, r in enumerate(reads[:45]):
            r = r[:50].lower() + "RYKMSWBDHV" + r[50:]
            q = _quals(rng, len(r) - (i % 4) * 7, 33)
            fh.write(f"@o{i}\r\n {r}\t\r\n+\r\n\t{q} \r\n")
        fh.write("@none\r\n\r\n+\r\n\r\n")
    f["odd_fa"] = str(d / "odd.fa")
    with open(f["odd_fa"], "w", newline="") as fh:
        for i, r in enumerate(reads[45:80]):
            fh.write(f">a{i}\r\n{r[:30]}  \r\n\r\n\t{r[30:]}\r\n")
    sam = []
    for i, r in enumerate(reads[:60]):
        flag = (0x100, 0x800, 0, 16)[i % 4] if i < 8 else 0
        sam.append((f"s{i}", flag, 1 + i, 60, f"{len(r)}M", r,
                    "*" if i % 5 == 2 else _quals(rng, len(r), 33)))
    sam.append(("star", 4, 0, 0, "*", "*", "*"))
    f["sam"] = str(d / "r.sam")
    write_sam(f["sam"], sam)
    f["sam_nohdr"] = str(d / "nohdr.sam")
    write_sam(f["sam_nohdr"], sam[10:40], header=False)
    f["bam"] = str(d / "r.bam")
    write_bam(f["bam"], [(f"b{i}", (0, 0x100, 0x800, 16)[i % 4] if i < 4
                          else 0, r)
                         for i, r in enumerate(reads[:70])])
    f["cram"] = str(d / "r.cram")
    tcram.write_cram(f["cram"], [
        (f"c{i}", r, None if i % 2 else
         rng.integers(2, 41, len(r)).astype(np.uint8))
        for i, r in enumerate(reads[:50])])
    # mapped CRAM: records rebuilt against chr1 (given by --ref)
    ref_seq = genome[:300]
    f["ref"] = str(d / "ref.fa")
    with open(f["ref"], "w") as fh:
        fh.write(f">chr1\n{ref_seq}\n>chr2\n{genome[300:500]}\n")
    f["mapped"] = str(d / "m.cram")
    _craft_mapped_cram(f["mapped"], "chr1", [
        ("m1", 5, 30, []),
        ("m2", 50, 20, [(4, "X", 1)]),
        ("m3", 100, 25, [(7, "I", b"GGT"), (15, "D", 4)]),
        ("m4", 150, 60, [(30, "X", 2)])])
    f["ref_seq"] = ref_seq
    return f


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _same_batches(got, want):
    assert len(got) == len(want) >= 1
    for (gc, gq, gcol), (wc, wq, wcol) in zip(got, want):
        assert gcol == wcol
        np.testing.assert_array_equal(gc, wc)
        assert (gq is None) == (wq is None)
        if gq is not None:
            np.testing.assert_array_equal(gq, wq)


READER_CASES = [("fa", 0), ("fq33", 0), ("fq64", 0), ("fq64", 33),
                ("fq33", 64), ("fqgz", 0), ("sam", 0), ("sam_nohdr", 0),
                ("bam", 0), ("cram", 0), ("zeroq", 0)]


@pytest.mark.parametrize("name,fq_offset", READER_CASES,
                         ids=[f"{n}-O{o}" for n, o in READER_CASES])
def test_readers_match_jax_native(files, monkeypatch, name, fq_offset):
    """The port's native reader (with and without prefetch) and its
    Python reader give the batches of the JAX package's native reader."""
    monkeypatch.setattr(jseqio, "FQ_OFFSET", fq_offset)
    path = files[name]
    want = list(jseqio.read_batches_native([path], 32, MAX_LEN, 3,
                                           prefetch=0, overlap=K))
    assert tseqio.reader_name() == "native"
    for prefetch in (0, 2):
        _same_batches(list(tseqio.read_batches_native(
            [path], 32, MAX_LEN, 3, prefetch=prefetch, overlap=K,
            fq_offset=fq_offset)), want)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tseqio.reader_name() == "python"
    _same_batches(list(tseqio.read_batches_native(
        [path], 32, MAX_LEN, 3, overlap=K, fq_offset=fq_offset)), want)
    if name == "fa":       # the long record came as overlapping rows
        assert any(c.shape[1] == MAX_LEN for c, _q, _c in want)
    if name == "zeroq":
        assert all(q is None for _c, q, _col in want)


WHOLE_CASES = [(("fa",), 0, None), (("fa",), 0, 100), (("fq33",), 0, None),
               (("fq64",), 0, None), (("fq64",), 33, None),
               (("fq33",), 64, None), (("fqgz",), 0, None),
               (("sam",), 0, None), (("sam_nohdr",), 0, None),
               (("bam",), 0, None), (("cram",), 0, None),
               (("zeroq",), 0, None), (("odd_fq",), 0, None),
               (("odd_fa", "odd_fq"), 0, 120),
               (("fq33", "cram", "fa", "sam", "bam"), 0, None)]


@pytest.mark.parametrize(
    "names,fq_offset,max_len", WHOLE_CASES,
    ids=[f"{'+'.join(n)}-O{o}-L{m}" for n, o, m in WHOLE_CASES])
def test_read_batches_match_jax_on_both_parsers(files, monkeypatch, names,
                                                fq_offset, max_len):
    """read_batches (thread's reader: whole records, clipped only to an
    integer max_len, batches of 32 reads across files) from the C++
    parser equals it from the Python parser and the JAX package's
    read_batches (whose all-zero qualities come as zeros, not None);
    CRAM parses in Python on both.  The counters count each parser's
    reads."""
    monkeypatch.setattr(jseqio, "FQ_OFFSET", fq_offset)
    paths = [files[n] for n in names]
    want = [(c, q if q is not None and q.any() else None, col)
            for c, q, col in jseqio.read_batches(paths, 32, max_len, 3)]
    nreads = {p: len(list(tseqio.parse_reads(p, fq_offset))) for p in paths}
    in_cram = sum(n for p, n in nreads.items() if tseqio._is_cram(p))
    for reader in ("native", "python"):
        if reader == "python":
            monkeypatch.setattr(tnative, "get_lib", lambda: None)
        assert tseqio.reader_name() == reader
        timing.reset()
        got = list(tseqio.read_batches(paths, 32, max_len, 3,
                                       fq_offset=fq_offset))
        _same_batches(got, want)
        assert sum(c.shape[0] for c, _q, _col in got) == sum(nreads.values())
        native = sum(nreads.values()) - in_cram if reader == "native" else 0
        assert (timing.COUNTERS["read.native"],
                timing.COUNTERS["read.python"]) == \
            (native, sum(nreads.values()) - native)
    widths = [c.shape[1] for c, _q, _col in want]
    if names == ("fa",):
        # the long record whole, or clipped; the empty one a row of 4s
        assert max(widths) == (max_len or 700)
        assert any((c == 4).all(axis=1).any() for c, _q, _col in want)
    if names == ("zeroq",):
        assert all(q is None for _c, q, _col in want)
    if len(names) > 1:     # a batch holds the end of one file and the next
        assert len(want) == -(-sum(nreads.values()) // 32) < sum(
            -(-n // 32) for n in nreads.values())


def test_build_reader_unchanged_on_a_chunked_long_record(tmp_path):
    """build's reader (read_batches_native) still splits a long record
    into rows that share K bases, batches that never span files, and
    keeps its own line rules (a '>' line with a tab is FASTA; blanks
    inside a line are bases): the batches of the JAX package's native
    reader, with and without prefetch."""
    rng = np.random.default_rng(5)
    long_seq = _dna(rng, 3000)
    fa = tmp_path / "long.fa"
    with open(fa, "w", newline="") as fh:
        fh.write(">first\tdesc\r\n" + _dna(rng, 90) + " \r\n")
        fh.write(">long\n")
        for j in range(0, len(long_seq), 80):
            fh.write(long_seq[j:j + 80] + "\n")
        fh.write(">empty\n>short\n" + _dna(rng, 40) + "\n")
    paths = [str(fa), str(fa)]
    want = list(jseqio.read_batches_native(paths, 4, MAX_LEN, 1,
                                           prefetch=0, overlap=K))
    for prefetch in (0, 2):
        _same_batches(list(tseqio.read_batches_native(
            paths, 4, MAX_LEN, 1, prefetch=prefetch, overlap=K)), want)
    rows = [r for c, _q, _col in want for r in c]
    step = MAX_LEN - K
    nchunks = -(-(len(long_seq) - K) // step)
    # per file: the first record, the long one's chunks, the short one
    assert len(rows) == 2 * (1 + nchunks + 1)
    chunks = rows[1:1 + nchunks]
    for a, b in zip(chunks, chunks[1:]):
        np.testing.assert_array_equal(a[step:], b[:K])
    got = np.concatenate([chunks[0]] + [c[K:] for c in chunks[1:]])
    np.testing.assert_array_equal(got[:len(long_seq)], tseqio.CHAR_TO_BASE[
        np.frombuffer(long_seq.encode(), np.uint8)])


@pytest.mark.parametrize("name", ["fa", "fq64", "fqgz", "sam", "sam_nohdr",
                                  "bam", "cram"])
def test_parse_reads_matches_jax(files, name):
    want = list(jseqio.parse_reads(files[name]))
    got = list(tseqio.parse_reads(files[name]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.seq) == (w.name, w.seq)
        assert (g.quals is None) == (w.quals is None)
        if g.quals is not None:
            np.testing.assert_array_equal(g.quals, w.quals)


def test_mapped_cram_decodes_against_cram_ref(files, monkeypatch):
    ref = {"chr1": files["ref_seq"]}
    monkeypatch.setattr(jseqio, "CRAM_REF", ref)
    want = [(r.name, r.seq) for r in jseqio.parse_reads(files["mapped"])]
    got = [(r.name, r.seq) for r in tseqio.parse_reads(files["mapped"],
                                                       cram_ref=ref)]
    assert got == want and len(got) == 4
    assert got[0][1] == files["ref_seq"][4:34]


def test_cram_copy_matches_original(tmp_path):
    rng = np.random.default_rng(8)
    reads = []
    for i in range(12):
        seq = _dna(rng, int(rng.integers(20, 150)))
        reads.append((f"x{i}", seq, None if i % 3 else
                      rng.integers(0, 41, len(seq)).astype(np.uint8)))
    for method in (tcram.METHOD_RANS, tcram.METHOD_GZIP):
        a, b = tmp_path / f"j{method}.cram", tmp_path / f"t{method}.cram"
        jcram.write_cram(str(a), reads, method=method)
        tcram.write_cram(str(b), reads, method=method)
        assert a.read_bytes() == b.read_bytes()
        got, want = list(tcram.parse_cram(str(a))), list(jcram.parse_cram(
            str(a)))
        assert [g[:2] for g in got] == [w[:2] for w in want] == \
            [r[:2] for r in reads]
        for g, w in zip(got, want):
            assert (g[2] is None) == (w[2] is None)
            if g[2] is not None:
                np.testing.assert_array_equal(g[2], w[2])
    data = bytes(rng.integers(60, 70, 3000, np.uint8))
    for enc in (tcram.rans_encode0, tcram.rans_encode1):
        assert enc(data) == getattr(jcram, enc.__name__)(data)
        assert tcram.rans_decode(enc(data)) == data


def _write_cigar_bam(path):
    """A BAM with two references and CIGARs of every kind."""
    refs = [(b"chr1", 5000), (b"chrX", 800)]
    out = b"BAM\x01" + struct.pack("<i", 3) + b"@HD"
    out += struct.pack("<i", len(refs))
    for nm, ln in refs:
        out += struct.pack("<i", len(nm) + 1) + nm + b"\x00"
        out += struct.pack("<i", ln)
    recs = [("a", 0, 0, 100, 60, [(10, 0), (2, 1), (5, 2), (20, 0)]),
            ("b", 16, 1, 7, 20, [(3, 4), (30, 0), (100, 3), (4, 7), (1, 8)]),
            ("c", 4, -1, -1, 0, []),
            ("d", 0x100, 0, 50, 60, [(12, 0), (3, 5), (6, 6)])]
    for name, flag, rid, pos, mapq, cigar in recs:
        qn = name.encode() + b"\x00"
        seq_len = 8
        body = struct.pack("<iiBBHHHiiii", rid, pos, len(qn), mapq, 0,
                           len(cigar), flag, seq_len, -1, -1, 0)
        body += qn + b"".join(struct.pack("<I", (n << 4) | op)
                              for n, op in cigar)
        body += bytes([0x12] * 4) + bytes([0xFF] * seq_len)
        out += struct.pack("<i", len(body)) + body
    with gzip.open(path, "wb") as fh:
        fh.write(out)


def test_parse_bam_alignments_matches_jax(tmp_path):
    path = str(tmp_path / "cig.bam")
    _write_cigar_bam(path)
    want = list(jseqio.parse_bam_alignments(path))
    assert list(tseqio.parse_bam_alignments(path)) == want
    assert [w[5] for w in want] == [35, 135, 0, 12]
    # absent qualities (0xFF) read as none, as in the native reader
    reads = list(tseqio.parse_reads(path))
    assert [r.name for r in reads] == ["a", "b", "c"]
    assert all(r.quals is None and r.seq == "AC" * 4 for r in reads)


# ---------------------------------------------------------------------------
# the native reader's per-handle offset and the prefetch thread
# ---------------------------------------------------------------------------

def _fastq_quals(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return [np.frombuffer(q.encode(), np.uint8).astype(np.int16)
            for q in lines[3::4]]


def test_two_readers_keep_their_own_offset(files):
    """Two native readers open at once, each on its own prefetch thread,
    one with -O 33 and one with -O 64 over the same +64 file."""
    raw = _fastq_quals(files["fq64"])
    it33 = tseqio.read_batches_native([files["fq64"]], 16, MAX_LEN,
                                      fq_offset=33, prefetch=2)
    it64 = tseqio.read_batches_native([files["fq64"]], 16, MAX_LEN,
                                      fq_offset=64, prefetch=2)
    row = 0
    for (c33, q33, _), (c64, q64, _) in zip(it33, it64):
        np.testing.assert_array_equal(c33, c64)
        for i in range(c33.shape[0]):
            q = raw[row + i]
            np.testing.assert_array_equal(q33[i, :len(q)], q - 33)
            np.testing.assert_array_equal(q64[i, :len(q)],
                                          np.clip(q - 64, 0, 255))
        row += c33.shape[0]
    assert row == len(raw)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "mctx-seq-prefetch" and t.is_alive()]


def test_abandoned_generator_stops_and_joins_its_thread(files):
    assert not _prefetch_threads()
    it = tseqio.read_batches_native([files["fq33"]] * 4, 4, MAX_LEN,
                                    prefetch=2)
    for i, _batch in enumerate(it):
        if i == 1:
            break
    assert _prefetch_threads()          # still parked on the full queue
    it.close()
    assert not _prefetch_threads()
    # a producer that fails surfaces its error on the consumer's side
    with pytest.raises(FileNotFoundError):
        list(tseqio.read_batches_native([files["fa"], "/nonexistent.fa"],
                                        prefetch=2))
    assert not _prefetch_threads()


def test_full_queue_keeps_the_end_marker(files):
    """A consumer slower than the producer: the producer finishes while
    the queue is full, and the consumer still gets every batch and the
    end (the reference's reader drops its end marker then and blocks)."""
    want = list(tseqio.read_batches_native([files["fq33"]], 16, MAX_LEN,
                                           prefetch=0))
    got = []
    for batch in tseqio.read_batches_native([files["fq33"]], 16, MAX_LEN,
                                            prefetch=2):
        time.sleep(0.05)
        got.append(batch)
    _same_batches(got, want)
    assert len(want) >= 8 and not _prefetch_threads()


def test_native_library_builds_into_the_package(tmp_path, monkeypatch):
    assert tnative.get_lib() is not None
    assert tnative.SO.endswith("mccortex_tpu_torch/_build/libmctxio.so")
    # without a compiler the build reports failure and nothing is loaded
    monkeypatch.setattr(tnative, "SO", str(tmp_path / "libmctxio.so"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tnative.build() is False
    assert not (tmp_path / "libmctxio.so").exists()


# ---------------------------------------------------------------------------
# mctx-torch build against mctx build, from every format
# ---------------------------------------------------------------------------

BUILD_CASES = {
    "zeroq": ["-Q", "5", "--seq", "zeroq"],
    "fa": ["--seq", "fa"],
    "fq": ["-Q", "12", "-H", "4", "--seq", "fq33", "--seq", "fq64"],
    "fqgz": ["-p", "--seq", "fqgz"],
    "sam": ["-Q", "10", "--seq", "sam", "--seq", "sam_nohdr"],
    "bam": ["--seq", "bam"],
    "cram": ["--seq", "cram"],
    "mapped_cram": ["--ref", "ref", "--seq", "mapped", "--seq", "cram"],
}


@pytest.fixture(scope="module")
def mctx_builds(files, tmp_path_factory):
    """Every case's .ctx from `mctx build`, built once for the module.
    `mctx build --ref` leaves its reference in the module global
    CRAM_REF: it is restored after each build."""
    d = tmp_path_factory.mktemp("mctx_builds")
    out = {}
    saved = jseqio.CRAM_REF
    try:
        for name, args in BUILD_CASES.items():
            out[name] = d / f"{name}.ctx"
            argv = [files.get(a, a) for a in args]
            assert mctx_main(["build", "-k", str(K), "-s", name] + argv
                             + ["-q", str(out[name])]) == 0
            jseqio.CRAM_REF = saved
    finally:
        jseqio.CRAM_REF = saved
    return out


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_matches_mctx_from_each_format(files, mctx_builds, tmp_path,
                                             monkeypatch, capsys, case,
                                             reader):
    if reader == "python":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    got = tmp_path / "port.ctx"
    argv = [files.get(a, a) for a in BUILD_CASES[case]]
    assert port_main(["build", "-k", str(K), "-s", case] + argv
                     + ["--device", "cpu", str(got)]) == 0
    assert f"({reader} reader)" in capsys.readouterr().err
    assert got.read_bytes() == mctx_builds[case].read_bytes()
    if case == "zeroq":     # qualities all 0: -Q masks nothing
        plain = tmp_path / "unmasked.ctx"
        assert port_main(["build", "-k", str(K), "-s", case, "--seq",
                          files["zeroq"], "--device", "cpu", "-q",
                          str(plain)]) == 0
        assert got.read_bytes() == plain.read_bytes()
        assert len(tctx.read_ctx(str(got))[1]) > 900


def test_formats_build_the_same_graph(files, tmp_path):
    """The same reads as FASTQ, SAM, BAM and CRAM build the same kmers
    and coverage (the headers differ only in the sample names)."""
    rng = np.random.default_rng(12)
    reads = [_dna(rng, int(rng.integers(40, 120))) for _ in range(30)]
    src = {"fq": tmp_path / "s.fq", "sam": tmp_path / "s.sam",
           "bam": tmp_path / "s.bam", "cram": tmp_path / "s.cram"}
    with open(src["fq"], "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    write_sam(str(src["sam"]), [(f"r{i}", 0, 1, 60, f"{len(r)}M", r,
                                 "I" * len(r)) for i, r in enumerate(reads)])
    write_bam(str(src["bam"]), [(f"r{i}", 0, r) for i, r in enumerate(reads)])
    tcram.write_cram(str(src["cram"]), [(f"r{i}", r, None)
                                        for i, r in enumerate(reads)])
    graphs = []
    for name, path in src.items():
        out = tmp_path / f"{name}.ctx"
        assert port_main(["build", "-k", "31", "-s", "s", "--seq", str(path),
                          "--device", "cpu", "-q", str(out)]) == 0
        graphs.append(out.read_bytes())
    assert len(set(graphs)) == 1

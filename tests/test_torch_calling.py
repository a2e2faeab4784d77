"""The port's breakpoint caller, vcfcov and vcfgeno
(mccortex_tpu_torch/calls/{breakpoints,genotyping,vcfgeno}.py and the
`breakpoints`, `vcfcov`, `vcfgeno` commands) against mccortex_tpu on the
CPU, exactly: break sites, Breakpoint lists field by field, and the
commands' bytes (call files decompressed with the header's `generator`
masked; VCF with `##source=` masked; BCF with that line masked in its
header text), on the inputs of tests/test_vcf_path.py, test_bcf.py and
test_cli_flags.py.

The breakpoint fixtures of tests/test_vcf_path.py (a 60 bp deletion, a
40 bp insertion, an insertion after the second copy of a repeated
flank) are three chromosomes of one k = 11 graph in two colours (the
reference, the sample), built once by mctx and loaded by each package
from the same .ctx, so that JAX compiles each walker program once.
"""

import dataclasses
import gzip
import os
import re
import struct

import numpy as np
import pytest

from mccortex_tpu.calls import breakpoints as jbk
from mccortex_tpu.calls import genotyping as jgt
from mccortex_tpu.calls import vcfgeno as jvg
from mccortex_tpu.cli.commands import _load_graphs as jload
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import kmer_occur as JKO
from mccortex_tpu.io import vcf as jvcf
from mccortex_tpu_torch.calls import breakpoints as tbk
from mccortex_tpu_torch.calls import genotyping as tgt
from mccortex_tpu_torch.calls import vcfgeno as tvg
from mccortex_tpu_torch.cli.commands import _load_graphs as tload
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import kmer_occur as TKO
from mccortex_tpu_torch.io import vcf as tvcf

from util import random_dna

K = 11


def _chroms():
    """{name: (reference, sample)}."""
    r1 = random_dna(400, seed=610)
    r2 = random_dna(500, seed=620)
    dup, a = random_dna(40, seed=710), random_dna(80, seed=711)
    b, tail = random_dna(80, seed=712), random_dna(80, seed=713)
    r3 = a + dup + b + dup + tail
    return {"chr1": (r1, r1[:170] + r1[230:]),
            "chr2": (r2, r2[:200] + random_dna(40, seed=621) + r2[200:]),
            "chr3": (r3, a + dup + b + dup + random_dna(30, seed=714)
                     + tail)}


def _fasta(path, named):
    with open(path, "w") as fh:
        for name, s in named:
            fh.write(f">{name}\n{s}\n")
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("calling")
    ch = _chroms()
    ref_fa = _fasta(str(d / "ref.fa"), [(n, r) for n, (r, _s) in ch.items()])
    s_fa = _fasta(str(d / "s.fa"), [(n, s) for n, (_r, s) in ch.items()])
    ctx = str(d / "g.ctx")
    assert mctx_main(["build", "-q", "-k", str(K), "-s", "ref", "-1",
                      ref_fa, "-s", "s", "-1", s_fa, ctx]) == 0
    _h, jg = jload([ctx])
    _h, tg = tload([ctx], "cpu")
    names = list(ch)
    seqs = [ch[n][0] for n in names]
    return dict(d=d, ctx=ctx, ref_fa=ref_fa, jg=jg, tg=tg, ch=ch,
                jref=JKO.RefGenome(names, seqs),
                tref=TKO.RefGenome(names, seqs), runs={})


def test_find_break_sites_matches_jax(data):
    jv, jn = jbk.find_break_sites(data["jg"], JKO.build_kograph(
        data["jg"], data["jref"]))
    tv, tn = tbk.find_break_sites(data["tg"], TKO.build_kograph(
        data["tg"], data["tref"]))
    assert len(jv) >= 6
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tn, jn)


def test_call_breakpoints_matches_jax(data):
    jc = jbk.call_breakpoints(data["jg"], data["jref"])
    tc = tbk.call_breakpoints(data["tg"], data["tref"])
    assert [dataclasses.asdict(c) for c in tc] == \
        [dataclasses.asdict(c) for c in jc]
    # the deletion on chr1: a 5' run ending at the break, the sample's
    # colour
    hits = [c for c in tc if c.flank5p_run["chrom"] == 0
            and abs(c.flank5p_run["last"] - (170 - K)) <= 1]
    assert hits and 1 in hits[0].cols


def _masked(text):
    text = re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)
    return re.sub(r"##source=[^\n]*", "##source=-", text)


def _read_masked(path):
    """Decompressed text, masked; BCF: the header text masked, its length
    field recomputed."""
    data = open(path, "rb").read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    if data[:3] == b"BCF":
        n = struct.unpack("<I", data[5:9])[0]
        text = _masked(data[9:9 + n].decode())
        return data[:5] + struct.pack("<I", len(text)) + text.encode() + \
            data[9 + n:]
    return _masked(data.decode()).encode()


def _both(capsys, d, argv, tag, status_words):
    """argv (OUT = the output path) through mctx and the port (--device
    cpu), one output path for both, each output moved aside; returns the
    masked outputs and status lines of (mctx, port)."""
    out = str(d / tag)
    a = [out if x == "OUT" else x for x in argv]
    res = []
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        capsys.readouterr()
        assert run(a) == 0
        err = capsys.readouterr().err
        os.replace(out, f"{out}.{side}")
        res.append((_read_masked(f"{out}.{side}"), [
            ln for ln in err.splitlines()
            if any(w in ln for w in status_words)]))
    return res


@pytest.fixture(scope="module")
def brk_file(data):
    """mctx's breakpoint call file of the graph (the input of calls2vcf
    for both packages)."""
    path = str(data["d"] / "mctx_brk.txt.gz")
    assert mctx_main(["breakpoints", "-q", "--seq", data["ref_fa"], "-o",
                      path, data["ctx"]]) == 0
    return path


@pytest.mark.parametrize("argv", [[], ["-E"]])
def test_breakpoints_command_matches_mctx(capsys, data, brk_file, argv):
    (jb, js), (tb, ts) = _both(
        capsys, data["d"], ["breakpoints", "--seq", data["ref_fa"], "-o",
                            "OUT"] + argv + [data["ctx"]],
        f"brk{len(argv)}.txt.gz", ["breakpoints ->"])
    assert tb == jb and ts == js and js
    text = jb.decode()
    assert text.count(">brkpnt.call") >= 9 and ":-:" in text
    # the repetitive flank of chr3 lists both of its runs
    assert re.search(r"5pflank chr=chr3:[^ \n]*,chr3:", text)
    assert _masked(gzip.open(brk_file, "rt").read()).encode() == jb


def _minus_only(path, out):
    """The calls of a breakpoint file whose 5' flank maps to the minus
    strand (tests/test_vcf_path.py::
    test_breakpoint_minus_strand_call_decomposes)."""
    text = gzip.open(path, "rt").read()
    keep, block, outl = False, [], []
    for ln in text.split("\n"):
        if ln.startswith(">") and ln.split()[0].endswith("5pflank"):
            block, keep = [ln], ":-:" in ln
        elif block:
            block.append(ln)
            if ln == "" and len(block) > 5:
                if keep:
                    outl.extend(block)
                block = []
        elif not ln.startswith(">"):
            outl.append(ln)
    with gzip.open(out, "wt") as fh:
        fh.write("\n".join(outl) + "\n")
    return out


@pytest.mark.parametrize("which", ["all", "minus"])
def test_breakpoint_calls2vcf_matches_mctx(capsys, data, brk_file, which):
    calls = brk_file if which == "all" else _minus_only(
        brk_file, str(data["d"] / "minus.txt.gz"))
    (jv, js), (tv, ts) = _both(
        capsys, data["d"], ["calls2vcf", "-o", "OUT", calls,
                            data["ref_fa"]], f"brk_{which}.vcf",
        ["variants"])
    assert tv == jv and ts == js
    recs = [ln.split("\t") for ln in jv.decode().splitlines()
            if not ln.startswith("#")]
    # the 60 bp deletion of chr1 and the 40 bp insertion of chr2
    assert any(len(r[3]) - len(r[4]) == 60 for r in recs)
    if which == "all":
        assert any(len(r[4]) - len(r[3]) == 40 for r in recs)


# ---------------------------------------------------------------------------
# vcfcov, vcfgeno
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cov(tmp_path_factory):
    """tests/test_vcf_path.py::test_vcfcov_and_vcfgeno's graph (sample A:
    4 reference reads, sample B: 4 of a SNP haplotype), with a VCF that
    also holds a neighbouring SNP, an insertion, a long deletion (past
    -L), a record on a contig the reference lacks and a two-ALT record."""
    d = tmp_path_factory.mktemp("vcfcov")
    ref = random_dna(300, seed=640)
    alt = "ACGT"[("ACGT".index(ref[150]) + 1) % 4]
    hap = ref[:150] + alt + ref[151:]
    ref_fa = _fasta(str(d / "ref.fa"), [("chr1", ref)])
    a_fa = _fasta(str(d / "a.fa"), [(f"a{i}", ref) for i in range(4)])
    b_fa = _fasta(str(d / "b.fa"), [(f"b{i}", hap) for i in range(4)])
    ctx = str(d / "g.ctx")
    assert mctx_main(["build", "-q", "-k", str(K), "--sample", "A", "--seq",
                      a_fa, "--sample", "B", "--seq", b_fa, ctx]) == 0
    alt2 = "ACGT"[("ACGT".index(ref[155]) + 2) % 4]
    rows = [("chr1", 151, ref[150], alt), ("chr1", 156, ref[155], alt2),
            ("chr1", 201, ref[200], ref[200] + "GATTACA"),
            ("chr1", 231, ref[230:360], ref[230]),
            ("chrX", 10, "A", "C"),
            ("chr1", 81, ref[80], "A,C" if ref[80] == "G" else "G,T")]
    vcf = str(d / "in.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for c, p, r, a in rows:
            fh.write(f"{c}\t{p}\t.\t{r}\t{a}\t.\t.\t.\n")
    return dict(d=d, ref=ref, alt=alt, ref_fa=ref_fa, ctx=ctx, vcf=vcf)


VCFCOV = {
    "default": [],
    "nvars_len": ["-N", "1", "-L", "5"],
    "bcf": ["-O", "bcf"],
    "modes": ["-M", "-H"],
}


@pytest.mark.parametrize("case", list(VCFCOV))
def test_vcfcov_command_matches_mctx(capsys, cov, case):
    (jv, js), (tv, ts) = _both(
        capsys, cov["d"], ["vcfcov", "-o", "OUT", "-r", cov["ref_fa"]]
        + VCFCOV[case] + [cov["vcf"], cov["ctx"]], f"cov_{case}.vcf",
        ["annotated", "warning"])
    assert tv == jv and ts == js
    if case == "default":
        rec = [ln.split("\t") for ln in jv.decode().splitlines()
               if ln.startswith("chr1\t151\t")][0]
        tags = dict(zip(rec[8].split(":"), rec[9].split(":")))
        tagsb = dict(zip(rec[8].split(":"), rec[10].split(":")))
        assert int(tags["K11R"]) >= 3 and int(tags["K11A"]) == 0
        assert int(tagsb["K11A"]) >= 3 and int(tagsb["K11R"]) == 0


def test_vcfcov_bcf_output_matches_mctx(capsys, tmp_path):
    """tests/test_bcf.py::test_vcfcov_bcf_output: the output written as
    BCF because of its extension."""
    genome = random_dna(200, seed=1200)
    alt = genome[:100] + ("A" if genome[100] != "A" else "C") \
        + genome[101:]
    fa = _fasta(str(tmp_path / "r.fa"), [("r0", genome), ("r1", alt)])
    ref_fa = _fasta(str(tmp_path / "ref.fa"), [("chr1", genome)])
    ctx = str(tmp_path / "g.ctx")
    assert mctx_main(["build", "-q", "-k", str(K), "--sample", "s",
                      "--seq", fa, ctx]) == 0
    invcf = str(tmp_path / "in.vcf")
    with open(invcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID=chr1,length={len(genome)}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.write(f"chr1\t101\tv1\t{genome[100]}\t{alt[100]}\t.\tPASS\t.\n")
    (jv, js), (tv, ts) = _both(
        capsys, tmp_path, ["vcfcov", "-o", "OUT", "-r", ref_fa, invcf, ctx],
        "out.bcf", ["annotated"])
    assert tv == jv and ts == js and jv[:3] == b"BCF"


def test_lookup_covg_matches_jax(cov):
    """The coverage of canonical keys, found and not found, through
    hashidx.lookup in both packages."""
    _h, jg = jload([cov["ctx"]])
    _h, tg = tload([cov["ctx"]], "cpu")
    keys = np.unique(np.concatenate([
        jgt._kmer_keys(cov["ref"], K),
        jgt._kmer_keys(random_dna(60, seed=5), K)]))
    np.testing.assert_array_equal(tgt._lookup_covg(tg, keys),
                                  jgt._lookup_covg(jg, keys))
    np.testing.assert_array_equal(tgt._kmer_keys(cov["ref"], K),
                                  jgt._kmer_keys(cov["ref"], K))


VCFGENO = {
    "kcov": ["--kcov", "4", "--read-len", "300"],
    "llk_rm": ["--kcov", "4,5", "--read-len", "300,250", "-l", "-r"],
    "cov_depth": ["--cov", "10", "-R", "100", "-E", "0.02"],
    "ploidy_one": ["--kcov", "4", "-P", "1"],
    "ploidy_rules": ["--kcov", "4", "-P", ".:.:2", "-P", "B:chr1:1",
                     "-l"],
    "ploidy_list": ["--kcov", "4", "-P", "1,2"],
    "bcf": ["--kcov", "4", "-O", "bcf"],
}


@pytest.mark.parametrize("case", list(VCFGENO))
def test_vcfgeno_command_matches_mctx(capsys, cov, case):
    covvcf = str(cov["d"] / "geno_in.vcf")
    if not os.path.exists(covvcf):
        assert port_main(["vcfcov", "-q", "-o", covvcf, "-r", cov["ref_fa"],
                          cov["vcf"], cov["ctx"], "--device", "cpu"]) == 0
    (jv, js), (tv, ts) = _both(
        capsys, cov["d"], ["vcfgeno", "-o", "OUT", "-k", str(K)]
        + VCFGENO[case] + [covvcf], f"geno_{case}.vcf", ["genotyped"])
    assert tv == jv and ts == js
    if case == "kcov":
        rec = [ln.split("\t") for ln in jv.decode().splitlines()
               if ln.startswith("chr1\t151\t")][0]
        assert rec[9].startswith("0/0") and rec[10].startswith("1/1")


def test_vcfgeno_matches_jax():
    """tests/test_vcf_path.py::test_vcfgeno_het and test_cli_flags.py::
    test_vcfgeno_ploidy_matcher, in both packages."""
    def het(mod):
        vcf = mod.VcfFile(
            headers=["##fileformat=VCFv4.2"], sample_names=["s"],
            records=[mod.VcfRecord(
                chrom="c", pos=100, vid=".", ref="A", alts=["T"],
                fmt=["K11R", "K11A"],
                samples=[{"K11R": "10", "K11A": "11"}])])
        return vcf

    jv, tv = het(jvcf), het(tvcf)
    assert tvg.genotype_vcf(tv, 11, kcovs=[20.0], errs=[0.01],
                            ploidy_spec=[2], readlensk=[90]) == \
        jvg.genotype_vcf(jv, 11, kcovs=[20.0], errs=[0.01],
                         ploidy_spec=[2], readlensk=[90])
    assert tv.records[0].samples == jv.records[0].samples
    assert tv.records[0].samples[0]["GT"] == "0/1"
    for v, vg in ((jv, jvg), (tv, tvg)):
        v.records[0].samples[0].update({"K11R": "20", "K11A": "0"})
        vg.genotype_record(v.records[0], 11, [20.0], [0.01], [2], [90],
                           "K11R", "K11A")
    assert tv.records[0].samples == jv.records[0].samples
    specs = [".:.:2", ".:Y:0", "John,Tom:X,Y:1"]
    names = ["John", "Anna", "Tom"]
    jl, tl = jvg.ploidy_matcher(specs, names), tvg.ploidy_matcher(specs,
                                                                  names)
    for s in range(4):
        for chrom in ("chr1", "X", "Y"):
            assert tl(s, chrom) == jl(s, chrom)
    assert tl(1, "Y") == 0 and tl(0, "Y") == 1

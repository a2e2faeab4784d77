"""The port's copies of the call-file, VCF/BCF and alignment modules
(mccortex_tpu_torch/io/{callfile,vcf,bcf}.py, align/nw.py,
calls/calls2vcf.py) and its `calls2vcf` command against mccortex_tpu on
the CPU, exactly: the same alignments and records, the same bytes
(`generator` and `##source=`, which name the package, masked), on the
inputs of tests/test_vcf_path.py, test_bcf.py, test_spec_vectors.py,
test_sam_bam.py and test_cli_flags.py.

Also the repair of a reference fault: mctx calls2vcf -m/-M/-g/-G set
the alignment scores process-wide (mccortex_tpu/align/nw.set_scoring),
so a later call in the same process scores with them; the port passes
them to each call (ROADMAP.md Queue 3).
"""

import dataclasses
import gzip
import os
import re
import struct

import numpy as np
import pytest

from mccortex_tpu.align import nw as jnw
from mccortex_tpu.calls import calls2vcf as jc2v
from mccortex_tpu.calls.bubbles import Bubble as JBubble
from mccortex_tpu.cli import commands3 as jcmd3
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import kmer_occur as JKO
from mccortex_tpu.io import bcf as jbcf
from mccortex_tpu.io import callfile as jcf
from mccortex_tpu.io import vcf as jvcf
from mccortex_tpu_torch.align import nw as tnw
from mccortex_tpu_torch.calls import calls2vcf as tc2v
from mccortex_tpu_torch.calls.bubbles import Bubble as TBubble
from mccortex_tpu_torch.cli import commands3 as tcmd3
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import kmer_occur as TKO
from mccortex_tpu_torch.io import bcf as tbcf
from mccortex_tpu_torch.io import callfile as tcf
from mccortex_tpu_torch.io import vcf as tvcf

from test_ctx_io import write_fasta
from test_sam_bam import write_bam_aln, write_sam
from util import random_dna

K = 11


# ---------------------------------------------------------------------------
# align/nw.py
# ---------------------------------------------------------------------------

def _nw_pairs():
    rng = np.random.default_rng(77)
    ref = "ACGTACGTAAGGTTCCACGT"
    pairs = [(ref, ref[:8] + "C" + ref[9:12] + ref[15:]), ("", "ACG"),
             ("ACG", ""), ("A", "C")]
    for n in (2, 5, 8, 13, 21, 30, 45, 61, 100):
        a = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
        b = list(a)
        for _ in range(3):
            op, p = rng.integers(0, 3), rng.integers(0, len(b))
            if op == 0:
                b[p] = "ACGT"[rng.integers(0, 4)]
            elif op == 1:
                del b[p]
            else:
                b.insert(p, "ACGT"[rng.integers(0, 4)])
        pairs.append((a, "".join(b)))
    return pairs


@pytest.fixture
def jax_scores():
    """Restores mctx's process-wide scores after a test sets them."""
    yield
    jnw.set_scoring()


@pytest.mark.parametrize("scores", [(1, -2, -4, -1), (2, -5, -3, -2)])
def test_nw_matches_jax(scores, jax_scores):
    jnw.set_scoring(*scores)
    sc = tnw.Scoring(*scores)
    for a, b in _nw_pairs():
        assert tnw.align(a, b, sc) == jnw.align(a, b)
        ref_full = "G" * 3 + a + "T" * 3
        assert tnw.decompose(a, b, 3, ref_full, sc) == \
            jnw.decompose(a, b, 3, ref_full)
    assert tnw.align("ACGT", "AGGT") == tnw.align("ACGT", "AGGT",
                                                  tnw.DEFAULT)


def _mnp_call_file(path, mod, bubble_cls, ref):
    """A bubble call whose allele is four reference bases rotated by one:
    one run of mismatches under the default scores, a deletion and an
    insertion once a mismatch costs -5 (-M -5)."""
    alt = ref[101:104] + ref[100]
    assert alt != ref[100:104]
    b = bubble_cls(fork_vertex=0, flank5p=ref[60:100], flank3p=ref[104:140],
                   branches=[ref[100:104], alt], branch_colsets=[[0], [1]])
    mod.write_bubble_file(path, [b], K, 2, 300, 1000, ["r", "s"])


def _src_masked(text):
    return re.sub(r"##source=[^\n]*", "##source=-", text)


def test_calls2vcf_scores_stay_with_their_call(tmp_path, jax_scores):
    """calls2vcf -M -5 through each package's command, then a default
    call of bubbles_to_vcf in the same process: the port's scores as the
    default; mctx's keeps -5 (the reference fault the port does not
    copy: its command sets the scores process-wide)."""
    ref = random_dna(200, seed=990)
    fa = str(tmp_path / "ref.fa")
    with open(fa, "w") as fh:
        fh.write(f">chr1\n{ref}\n")
    calls = str(tmp_path / "mnp.txt.gz")
    _mnp_call_file(calls, tcf, TBubble, ref)
    outs = {}
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        for extra in ([], ["-M", "-5"]):
            out = str(tmp_path / f"{side}{len(extra)}.vcf")
            assert run(["calls2vcf", "-q", "-o", out] + extra
                       + [calls, fa]) == 0
            outs[side, len(extra)] = _src_masked(open(out).read())
    assert outs["t", 0] == outs["j", 0] and outs["t", 2] == outs["j", 2]
    assert outs["t", 0] != outs["t", 2]
    # a default call after `calls2vcf -M -5`, in the same process
    _hdr, cl = tcf.read_call_file(calls)
    tr, _ = tc2v.bubbles_to_vcf(cl, TKO.RefGenome(["chr1"], [ref]), K)
    jr, _ = jc2v.bubbles_to_vcf(cl, JKO.RefGenome(["chr1"], [ref]), K)
    assert [(r.pos, r.ref, r.alts) for r in tr] == [(100, ref[100:103],
                                                     [ref[101:104]])]
    assert [(r.pos, r.ref, r.alts) for r in jr] != \
        [(r.pos, r.ref, r.alts) for r in tr]     # mctx: -5 left behind


# ---------------------------------------------------------------------------
# io/callfile.py, io/vcf.py, io/bcf.py
# ---------------------------------------------------------------------------

def _masked(text):
    return re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)


def test_callfile_matches_jax(tmp_path):
    rng = np.random.default_rng(5)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    spec = [dict(fork_vertex=i, flank5p=seq(20 + i), flank3p=seq(7 + i),
                 branches=[seq(i), seq(i + 3), seq(2)][:2 + i % 2],
                 branch_colsets=[[0], [1], [0, 1]][:2 + i % 2])
            for i in range(5)]
    paths = {}
    for name, mod, cls in (("j", jcf, JBubble), ("t", tcf, TBubble)):
        paths[name] = str(tmp_path / f"{name}.txt.gz")
        mod.write_bubble_file(paths[name], [cls(**s) for s in spec], K, 2,
                              300, 1000, sample_names=["a", "b"])
    jt, tt = (gzip.open(paths[s], "rt").read() for s in "jt")
    assert _masked(tt) == _masked(jt)
    assert '"generator": "mccortex_tpu_torch 0.1.0"' in tt
    for p in paths.values():
        assert tcf.read_call_file(p) == jcf.read_call_file(p)


def _vcf_file(mod):
    """tests/test_bcf.py's records, in either package's classes."""
    headers = [
        "##fileformat=VCFv4.2",
        "##contig=<ID=chr1,length=5000>",
        "##contig=<ID=chr2,length=3000>",
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">',
        '##FORMAT=<ID=K21R,Number=A,Type=Integer,Description="x">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">',
    ]
    recs = [
        mod.VcfRecord(chrom="chr1", pos=99, vid="v1", ref="A", alts=["C"],
                      qual=".", filt="PASS", info={"DP": 33}, fmt=["K21R"],
                      samples=[{"K21R": 7}, {"K21R": "."}]),
        mod.VcfRecord(chrom="chr2", pos=4, vid=".", ref="AT",
                      alts=["A", "ATT"], qual="50", filt="PASS", info={},
                      fmt=["GT"], samples=[{"GT": "0/1"}, {"GT": "1|1"}]),
        mod.VcfRecord(chrom="chr2", pos=9, vid=".", ref="G", alts=["T"],
                      info={"FLAG": True}, fmt=["GT"],
                      samples=[{"GT": "1|0"}, {"GT": "."}]),
    ]
    return mod.VcfFile(headers=headers, sample_names=["s1", "s2"],
                       records=recs)


def _records(v):
    return [dataclasses.asdict(r) for r in v.records]


@pytest.mark.parametrize("fmt", ["vcf", "vcfgz", "bcf", "ubcf", None])
def test_vcf_bcf_writers_match_jax(tmp_path, fmt):
    ext = {"vcfgz": ".vcf.gz", "bcf": ".bcf", "ubcf": ".bcf", None: ".bcf"}
    out = {}
    for side, mod in (("j", jvcf), ("t", tvcf)):
        out[side] = str(tmp_path / f"{side}{ext.get(fmt, '.vcf')}")
        mod.write_variants(out[side], _vcf_file(mod), fmt=fmt)
    assert open(out["t"], "rb").read() == open(out["j"], "rb").read()
    if fmt == "ubcf":   # neither package's reader takes uncompressed BCF
        return
    jv, tv = jvcf.read_variants(out["j"]), tvcf.read_variants(out["t"])
    assert _records(tv) == _records(jv)
    assert (tv.headers, tv.sample_names) == (jv.headers, jv.sample_names)


def test_bcf_spec_vectors_read_alike(tmp_path):
    """The hand-packed BCF of tests/test_spec_vectors.py and the GT
    coding vector, read by both packages."""
    import test_spec_vectors as sv
    sv.test_bcf_spec_vector(tmp_path)
    sv.test_bcf_gt_coding_roundtrip(tmp_path)
    for name in ("spec.bcf", "ours.bcf"):
        p = str(tmp_path / name)
        jv, tv = jbcf.read_bcf(p), tbcf.read_bcf(p)
        assert _records(tv) == _records(jv) and _records(tv)
        assert (tv.headers, tv.sample_names) == (jv.headers,
                                                 jv.sample_names)
    # the port's writer emits the same GT coding
    rec = tvcf.VcfRecord(chrom="c", pos=5, vid=".", ref="A", alts=["T"],
                         qual="10", filt="PASS", info={}, fmt=["GT"],
                         samples=[{"GT": "1|0"}, {"GT": "."}])
    vf = tvcf.VcfFile(headers=["##fileformat=VCFv4.2", "##contig=<ID=c>",
                               '##FORMAT=<ID=GT,Number=1,Type=String,'
                               'Description="g">'],
                      sample_names=["a", "b"], records=[rec])
    p = str(tmp_path / "port.bcf")
    tbcf.write_bcf(p, vf)
    assert open(p, "rb").read() == open(tmp_path / "ours.bcf", "rb").read()
    assert bytes([0x21]) + struct.pack("<4b", 4, 3, 0, -127) in \
        gzip.open(p, "rb").read()


# ---------------------------------------------------------------------------
# calls/calls2vcf.py and the calls2vcf command
# ---------------------------------------------------------------------------

def _bcf_masked(path):
    """A BCF's payload with the header text's ##source= line masked (its
    length field recomputed)."""
    data = open(path, "rb").read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    n = struct.unpack("<I", data[5:9])[0]
    text = _src_masked(data[9:9 + n].decode())
    return data[:5] + struct.pack("<I", len(text)) + text.encode() + \
        data[9 + n:]


def _read_masked(path):
    data = open(path, "rb").read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    if data[:3] == b"BCF":
        return _bcf_masked(path)
    return _src_masked(data.decode()).encode()


@pytest.fixture(scope="module")
def snp_calls(tmp_path_factory):
    """The bubble calls of tests/test_vcf_path.py::
    test_bubbles_to_vcf_snp and test_cli_flags.py::
    test_calls2vcf_out_fmt_bcf (a SNP between a reference and a donor),
    written by the port (tests/test_torch_bubbles.py holds its bubble
    files to mctx's)."""
    d = tmp_path_factory.mktemp("c2v")
    out = {}
    for name, seed, at in (("vcf_path", 630, 150), ("cli_flags", 603, 200)):
        ref = random_dna(300 if seed == 630 else 400, seed=seed)
        alt = "ACGT"[("ACGT".index(ref[at]) + 1) % 4]
        ref_fa, s_fa = str(d / f"{name}_ref.fa"), str(d / f"{name}_s.fa")
        write_fasta(ref_fa, [ref])
        write_fasta(s_fa, [ref[:at] + alt + ref[at + 1:]])
        ctx, bub = str(d / f"{name}.ctx"), str(d / f"{name}.txt.gz")
        cpu = ["-q", "--device", "cpu"]
        assert port_main(["build", "-k", str(K), "-s", "ref", "-1",
                          ref_fa, "-s", "s", "-1", s_fa, ctx] + cpu) == 0
        assert port_main(["bubbles", "-o", bub, ctx] + cpu) == 0
        out[name] = (ref_fa, bub, ref, at, alt)
    return d, out


@pytest.mark.parametrize("fixture", ["vcf_path", "cli_flags"])
@pytest.mark.parametrize("fmt", [None, "vcf", "vcfgz", "bcf", "ubcf"])
def test_calls2vcf_command_matches_mctx(capsys, snp_calls, fixture, fmt):
    d, fx = snp_calls
    ref_fa, bub, ref, at, alt = fx[fixture]
    out = str(d / f"out_{fixture}_{fmt}.{'bcf' if fmt is None else 'x'}")
    argv = ["calls2vcf", "-o", out] + (["-O", fmt] if fmt else []) \
        + [bub, ref_fa]
    res = []
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        capsys.readouterr()
        assert run(argv) == 0
        err = capsys.readouterr().err
        os.replace(out, f"{out}.{side}")
        res.append((_read_masked(f"{out}.{side}"), [
            ln for ln in err.splitlines() if "variants" in ln]))
    assert res[1] == res[0]
    if fmt in (None, "vcf"):
        t = f"{out}.t"
        v = jbcf.read_bcf(t) if fmt is None else jvcf.read_vcf(t)
        assert [(r.pos, r.ref, r.alts) for r in v.records] == \
            [(at, ref[at], [alt])]


def test_bubbles_to_vcf_and_breakpoint_runs_match_jax():
    """The inputs of test_vcf_path.py::test_calls2vcf_largest_run_choice:
    run parsing, the largest-run choice and the breakpoint decomposition;
    and breakpoints_to_vcf on a run pair of each strand."""
    k = K
    dup = random_dna(40, seed=720)
    a = random_dna(60, seed=721)
    b = random_dna(49, seed=722)
    tail = random_dna(80, seed=723)
    ext = b[-k:]
    ref_seq = a + dup + b + ext + dup + random_dna(20, seed=724) + tail
    p1, p2 = len(a), len(a) + len(dup) + len(b)
    t3 = p2 + len(ext) + len(dup) + 20
    call = {"name": "brkpnt.call0",
            "flank5p_hdr": "brkpnt.call0.5pflank chr="
                           f"chr1:{p1 + 1}-{p1 + len(dup)}:+:{len(ext) + 1},"
                           f"chr1:{p2 + 1}-{p2 + len(ext) + len(dup)}:+:1",
            "flank3p_hdr": f"brkpnt.call0.3pflank chr=chr1:{t3 + 1}-"
                           f"{t3 + 40}:+:1",
            "flank5p": ext + dup, "flank3p": ref_seq[t3:t3 + 40],
            "branches": [("path", "")]}
    name_idx = {"chr1": 0}
    for which, first in (("flank5p", False), ("flank3p", True)):
        runs = tcmd3._parse_chr_runs(call, which, name_idx, k)
        assert runs == jcmd3._parse_chr_runs(call, which, name_idx, k)
        assert tcmd3._largest_run(runs, first) == \
            jcmd3._largest_run(runs, first)
    jref, tref = JKO.RefGenome(["chr1"], [ref_seq]), \
        TKO.RefGenome(["chr1"], [ref_seq])
    jr, jd = jcmd3._breakpoint_calls_to_vcf([call], jref, k, jc2v)
    tr, td = tcmd3._breakpoint_calls_to_vcf([call], tref, k, tc2v)
    assert td == jd == 0 and _records(tvcf.VcfFile([], [], tr)) == \
        _records(jvcf.VcfFile([], [], jr))
    # breakpoints_to_vcf: a deletion on the plus strand, and a pair of
    # runs on different strands (dropped)
    from mccortex_tpu.calls.breakpoints import Breakpoint as JBp
    from mccortex_tpu_torch.calls.breakpoints import Breakpoint as TBp
    r5 = {"chrom": 0, "first": 50, "last": 90, "strand": 0, "len": 41}
    r3 = {"chrom": 0, "first": 130, "last": 160, "strand": 0, "len": 31}
    kw = [dict(flank5p_seq="", flank5p_run=r5, flank3p_seq="",
               flank3p_run=r3, allele_seq=ref_seq[101:110], cols=[1]),
          dict(flank5p_seq="", flank5p_run=r5, flank3p_seq="",
               flank3p_run=dict(r3, strand=1), allele_seq="", cols=[0])]
    jr, jd = jc2v.breakpoints_to_vcf([JBp(**x) for x in kw], jref, k)
    tr, td = tc2v.breakpoints_to_vcf([TBp(**x) for x in kw], tref, k)
    assert td == jd == 1 and tr
    assert _records(tvcf.VcfFile([], [], tr)) == \
        _records(jvcf.VcfFile([], [], jr))


@pytest.mark.parametrize("fmt", ["sam", "bam", "bam_clip", "sam_lowq"])
def test_calls2vcf_flanks_match_mctx(tmp_path, capsys, fmt):
    """-F: a 5' flank that ends in a repeated kmer is placed by a mapped
    SAM/BAM record (tests/test_sam_bam.py's inputs); the placements, the
    records and the command's VCF bytes equal mctx's."""
    dup = random_dna(40, seed=960)
    uniq1 = random_dna(60, seed=961)
    mid = random_dna(30, seed=962)
    tail = random_dna(60, seed=963)
    ref_seq = uniq1 + dup + mid + dup + "A" + tail
    pos1 = len(uniq1) + len(dup) + len(mid) + 1
    call = {"name": "bubble.call0", "flank5p": dup, "flank3p": tail[:30],
            "branches": [("b0", "A"), ("b1", "C")]}
    fl = str(tmp_path / f"flanks.{fmt[:3]}")
    mapq = 5 if fmt == "sam_lowq" else 60
    if fmt.startswith("sam"):
        write_sam(fl, [("bubble.call0", 0, pos1, mapq, f"{len(dup)}M", dup,
                        "I" * len(dup))])
    else:
        ops = [(len(dup), "M")] if fmt == "bam" else \
            [(5, "S"), (len(dup) - 5, "M"), (3, "D")]
        write_bam_aln(fl, [("bubble.call0", 0, pos1, mapq, ops, dup)])
    jref = JKO.RefGenome(["chr1"], [ref_seq])
    tref = TKO.RefGenome(["chr1"], [ref_seq])
    jp, tp = jc2v.load_flank_sam(fl, jref, 30), tc2v.load_flank_sam(fl, tref,
                                                                   30)
    assert tp == jp
    jr, jd = jc2v.bubbles_to_vcf([call], jref, K, sam_places=jp)
    tr, td = tc2v.bubbles_to_vcf([call], tref, K, sam_places=tp)
    assert td == jd and _records(tvcf.VcfFile([], [], tr)) == \
        _records(jvcf.VcfFile([], [], jr))
    assert (len(tr) == 1) == (fmt in ("sam", "bam"))
    # the command, on a call file holding the same call
    ref_fa = str(tmp_path / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(f">chr1\n{ref_seq}\n")
    calls = str(tmp_path / "calls.txt.gz")
    tcf.write_bubble_file(calls, [TBubble(0, dup, tail[:30], ["A", "C"],
                                          [[0], [1]])], K, 2, 300, 1000)
    outs = []
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        out = str(tmp_path / f"{side}.vcf")
        capsys.readouterr()
        assert run(["calls2vcf", "-F", fl, "-Q", "30", "-o", out, calls,
                    ref_fa]) == 0
        outs.append((_src_masked(open(out).read()), [
            ln for ln in capsys.readouterr().err.splitlines()
            if "variants" in ln]))
    assert outs[1] == outs[0]

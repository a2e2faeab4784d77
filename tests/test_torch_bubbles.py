"""The port's bubble caller (mccortex_tpu_torch/calls/bubbles.py,
pop_bubbles.py and the `bubbles`/`popbubbles` commands) against
mccortex_tpu on the CPU, exactly: fork vertices, the forced first step
of the branch walkers field by field, Bubble lists field by field, the
popped graph, and the commands' bytes (call files decompressed, only the
header's `generator` masked).  The goldens chain `build -> thread ->
bubbles -> calls2vcf` through the port gives tests/goldens' digests.

The fixtures of tests/test_bubbles.py (a SNP between two colours, a
diploid SNP in one colour, a linear genome, an insertion, nested
bubbles, serial bubbles resolved by links) are one k = 11 graph in two
colours, built once by mctx and loaded by each package from the same
.ctx, so that JAX compiles each walker program once (one walker count
and one max_allele a call; ROADMAP.md "Test and chip budget").
"""

import dataclasses
import gzip
import json
import os
import re

import numpy as np
import pytest

from mccortex_tpu.calls import bubbles as jbub
from mccortex_tpu.calls import pop_bubbles as jpop
from mccortex_tpu.cli.commands import _load_graphs as jload
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.io import ctp as jctp
from mccortex_tpu_torch.calls import bubbles as tbub
from mccortex_tpu_torch.calls import pop_bubbles as tpop
from mccortex_tpu_torch.cli.commands import _load_graphs as tload
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.graph import unitigs as tunitigs
from mccortex_tpu_torch.io import ctp as tctp
from mccortex_tpu_torch.links import walk as twalk

from test_torch_links import state_equal
from util import random_dna

K = 11
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _snp(seed, glen=200, at=100):
    a = random_dna(glen, seed=seed)
    alt = "ACGT"[("ACGT".index(a[at]) + 1) % 4]
    return a, a[:at] + alt + a[at + 1:]


def _sources():
    """(colour 0 sequences, colour 1 sequences, sequences threaded)."""
    a, b = _snp(400)                 # SNP between the colours
    d1, d2 = _snp(410)               # diploid SNP in colour 0
    lin = random_dna(300, seed=430)  # no bubble
    ia = random_dna(160, seed=440)   # 7 bp insertion between the colours
    ib = ia[:80] + random_dna(7, seed=441) + ia[80:]
    L, M = random_dna(40, seed=460), random_dna(30, seed=461)
    Q, R = random_dna(30, seed=462), random_dna(40, seed=463)
    opts = [c for c in "ACGT" if c != L[-1]]
    nested = [L + opts[0] + M + R, L + opts[1] + M + R, L + opts[2] + Q + R]
    L2, M2 = random_dna(40, seed=470), random_dna(30, seed=471)
    R2 = random_dna(40, seed=472)
    a1 = "A" if L2[-1] != "A" else "C"
    a2 = "G" if a1 != "G" else "T"
    b1 = "A" if M2[-1] != "A" else "C"
    b2 = "G" if b1 != "G" else "T"
    serial = [L2 + a1 + M2 + b1 + R2, L2 + a2 + M2 + b2 + R2]
    c0 = [a, d1, d2, lin, ia] + nested + serial
    return c0, [b, ib], serial


def _fasta(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">r{i}\n{s}\n")
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("bubbles")
    c0, c1, serial = _sources()
    f0, f1 = _fasta(str(d / "c0.fa"), c0), _fasta(str(d / "c1.fa"), c1)
    fs = _fasta(str(d / "serial.fa"), serial)
    ctx, ctp = str(d / "g.ctx"), str(d / "l.ctp.gz")
    assert mctx_main(["build", "-q", "-k", str(K), "-s", "a", "-1", f0,
                      "-s", "b", "-1", f1, ctx]) == 0
    assert mctx_main(["thread", "-q", "--no-gap-fill", "--seq", fs, "-o",
                      ctp, ctx]) == 0
    _h, jg = jload([ctx])
    _h, tg = tload([ctx], "cpu")
    return dict(d=d, ctx=ctx, ctp=ctp, jg=jg, tg=tg,
                jl=jctp.load_link_store([ctp], jg),
                tl=tctp.load_link_store([ctp], tg), runs={})


def _bubble_dicts(bl):
    return [dataclasses.asdict(b) for b in bl]


CASES = {
    # name: (with links, haploid colours, remove_serial)
    "plain": (False, (), True),
    "haploid_0": (False, (0,), True),
    "haploid_both": (False, (0, 1), True),
    "links": (True, (), True),
    "links_keep_serial": (True, (), False),
}


def _calls(data, case, monkeypatch):
    """JAX's and the port's call_bubbles, once a case; JAX's
    _force_first_step calls recorded (inputs and output)."""
    if case not in data["runs"]:
        links, hap, serial = CASES[case]
        rec = []
        real = jbub._force_first_step

        def spy(g, links_, st, nuc, colours):
            out = real(g, links_, st, nuc, colours)
            rec.append((st, np.asarray(nuc), np.asarray(colours), out))
            return out

        monkeypatch.setattr(jbub, "_force_first_step", spy)
        jb = jbub.call_bubbles(data["jg"], data["jl"] if links else None,
                               haploid_cols=hap, remove_serial=serial)
        monkeypatch.undo()
        tb = tbub.call_bubbles(data["tg"], data["tl"] if links else None,
                               haploid_cols=hap, remove_serial=serial)
        data["runs"][case] = (jb, tb, rec)
    return data["runs"][case]


def test_find_fork_vertices(data):
    want = jbub.find_fork_vertices(data["jg"])
    got = tbub.find_fork_vertices(data["tg"])
    assert len(want) > 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["plain", "links"])
def test_force_first_step_matches_jax(data, case, monkeypatch):
    """The forced branch step from JAX's own walker state, every field of
    the state that comes out."""
    import torch
    _jb, _tb, rec = _calls(data, case, monkeypatch)
    assert len(rec) == 1
    st, nuc, colours, want = rec[0]
    tl = data["tl"] if CASES[case][0] else None
    if tl is None:
        from mccortex_tpu_torch.links import store as tls
        tl = tls.empty(data["tg"].capacity, data["tg"].ncols, device="cpu")
    got = tbub._force_first_step(
        data["tg"], tl, twalk.state_from_numpy(st, "cpu"),
        torch.from_numpy(nuc.astype(np.uint8)),
        torch.from_numpy(colours.astype(np.int64)))
    state_equal(got, want)
    assert int(np.asarray(want.base.active).sum()) > 10


@pytest.mark.parametrize("case", list(CASES))
def test_call_bubbles_matches_jax(data, case, monkeypatch):
    jb, tb, _rec = _calls(data, case, monkeypatch)
    assert _bubble_dicts(tb) == _bubble_dicts(jb)
    if case == "plain":
        # the SNPs, the insertion and the nested bubbles are called
        assert len(tb) >= 4
    if case == "haploid_both":
        assert len(tb) < len(_calls(data, "plain", monkeypatch)[1])
    if case == "links_keep_serial":
        assert len(tb) > len(_calls(data, "links", monkeypatch)[1])


@pytest.mark.parametrize("opts", [{}, {"max_kdiff": 0, "max_covg": 1}])
def test_pop_bubbles_matches_jax(data, opts):
    jg2, jn = jpop.pop_bubbles(data["jg"], **opts)
    tg2, tn = tpop.pop_bubbles(data["tg"], **opts)
    assert tn == jn and tg2.n == int(jg2.n)
    for a, b in zip(tstore.to_host(tg2), jstore.to_host(jg2)):
        np.testing.assert_array_equal(a, b)
    if not opts:
        assert tn > 0 and tg2.n < data["tg"].n


def _masked(text):
    return re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)


def _both(capsys, data, argv, tag):
    """argv (OUT = the output path) through mctx and the port (--device
    cpu), one output path for both, each output moved aside; returns
    [(output path, stderr, rc)] for (mctx, port)."""
    out = str(data["d"] / tag)
    a = [out if x == "OUT" else x for x in argv]
    res = []
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        capsys.readouterr()
        rc = run(a)
        err = capsys.readouterr().err
        if os.path.exists(out):
            os.replace(out, f"{out}.{side}")
        res.append((f"{out}.{side}", err, rc))
    return res


def _status(err, word):
    return [ln for ln in err.splitlines() if ln.startswith(f"[mctx] {word}")]


BUBBLES = {
    "default": [],
    "haploid_list": ["-H", "0"],
    "haploid_all": ["-H", "*"],
    "links_keep_serial": ["-p", "CTP", "-S"],
    "flank": ["-F", "30"],
}


@pytest.mark.parametrize("case", list(BUBBLES))
def test_bubbles_command_matches_mctx(capsys, data, case):
    argv = [data["ctp"] if x == "CTP" else x for x in BUBBLES[case]]
    (jp, jerr, jrc), (tp, terr, trc) = _both(
        capsys, data, ["bubbles", "-o", "OUT"] + argv + [data["ctx"]],
        f"bub_{case}.txt.gz")
    assert jrc == trc == 0
    want = _masked(gzip.open(jp, "rt").read())
    assert want.count('"generator": "-"') == 1
    assert _masked(gzip.open(tp, "rt").read()) == want
    assert _status(terr, "found") == _status(jerr, "found")
    assert "bubble.call0.5pflank" in want


def test_clipped_hop_bubbles_match_mctx(capsys, data):
    """-A 20 is shorter than the unitig after the SNPs converge (89
    kmers), so every branch walker's hop into it is cut by the step
    budget: where mctx lands such a hop on the full jump's target and
    the port J positions ahead (ROADMAP.md Queue 3), the walks stop
    there, and the call files are equal."""
    tg = data["tg"]
    uv = tunitigs.unitig_view(tg.keys, tstore.union_edges(tg), K)
    assert int(uv.length[:tg.n].max()) > 20 + 60
    (jp, jerr, jrc), (tp, terr, trc) = _both(
        capsys, data, ["bubbles", "-A", "20", "-o", "OUT", data["ctx"]],
        "bub_clipped.txt.gz")
    assert jrc == trc == 0
    want = _masked(gzip.open(jp, "rt").read())
    assert _masked(gzip.open(tp, "rt").read()) == want
    assert '"max_allele_kmers": 20' in want and "branch.1" in want


@pytest.mark.parametrize("argv", [[], ["-C", "1", "-L", "20", "-D", "0"]])
def test_popbubbles_command_matches_mctx(capsys, data, argv):
    tag = "pop_" + "_".join(a.strip("-") for a in argv) + ".ctx"
    (jp, jerr, jrc), (tp, terr, trc) = _both(
        capsys, data, ["popbubbles", "-o", "OUT"] + argv + [data["ctx"]],
        tag)
    assert jrc == trc == 0
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert _status(terr, "popped") == _status(jerr, "popped")
    assert _status(jerr, "popped")


def test_goldens_chain_through_the_port(tmp_path):
    """mctx-torch build -> thread -> bubbles -> calls2vcf on
    tests/test_goldens.py's fixture gives MANIFEST.json's out.vcf digest,
    and the goldens' bubble file with `generator` masked on both sides."""
    from test_goldens import _digest, _fixture_seqs
    genome, reads = _fixture_seqs()
    fa = _fasta(str(tmp_path / "reads.fa"), reads)
    ref_fa = str(tmp_path / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(f">chr1\n{genome}\n")
    ctx, ctp = str(tmp_path / "g.ctx"), str(tmp_path / "l.ctp.gz")
    bub, vcf = str(tmp_path / "bubbles.txt.gz"), str(tmp_path / "out.vcf")
    cpu = ["--device", "cpu", "-q"]
    assert port_main(["build", "-k", str(K), "--sample", "golden", "--seq",
                      fa, ctx] + cpu) == 0
    assert port_main(["thread", "--seq", fa, "-o", ctp, ctx] + cpu) == 0
    assert port_main(["bubbles", "-o", bub, "-p", ctp, ctx] + cpu) == 0
    assert port_main(["calls2vcf", "-o", vcf, bub, ref_fa] + cpu) == 0
    want = json.load(open(os.path.join(GOLD, "MANIFEST.json")))
    assert _digest(vcf) == want["out.vcf"]
    assert _digest(ctx) == want["g.ctx"]
    gold = gzip.open(os.path.join(GOLD, "bubbles.txt.gz"), "rt").read()
    assert _masked(gzip.open(bub, "rt").read()) == _masked(gold)
    assert "mccortex_tpu_torch" in gzip.open(bub, "rt").read()

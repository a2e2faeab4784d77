"""The port's link-file layer (mccortex_tpu_torch/io/ctp.py,
links/store.py) and `mctx-torch pjoin | pview` against mccortex_tpu on
the CPU: the repo's golden g.ctx + l.ctp.gz, and a link file of random
links (duplicates, shared prefixes, junction strings over one and two
64-bit words) against a three-colour graph.  Arrays and text: exact
equality.  `.ctp` files are gzip, whose header holds an mtime, and
their JSON header holds the date, the working directory and the
generator (the package that wrote the file), so the files are compared
decompressed, with the date fixed on both sides and only the
`generator` value masked.
"""

import gzip
import os
import re
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.cli.commands import _load_graph as jload
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.io import ctp as jctp
from mccortex_tpu.links import store as jls
from mccortex_tpu.utils import text as jtext
from mccortex_tpu_torch.cli.commands import _load_graph as tload
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.io import ctp as tctp
from mccortex_tpu_torch.links import store as tls
from mccortex_tpu_torch.utils import text as ttext

from test_ctx_io import write_fasta
from util import random_dna

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
K = 11
DATE = "2026-01-02 03:04:05"


@pytest.fixture(autouse=True)
def fixed_date(monkeypatch):
    """Both packages stamp the header through time.strftime."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: DATE)


def _random_links(n, seed=3):
    """Raw link records on rows < n, two colours: per vertex a random
    junction string, its prefixes, exact repeats and unrelated strings,
    up to 40 junctions (two words)."""
    rng = np.random.default_rng(seed)
    rows, orients, seqs, cols = [], [], [], []
    for r in rng.choice(n, size=min(n, 40), replace=False):
        o = int(rng.integers(0, 2))
        full = rng.integers(0, 4, int(rng.integers(1, 41)))
        for _ in range(int(rng.integers(1, 6))):
            cut = int(rng.integers(1, len(full) + 1))
            s = full[:cut] if rng.random() < 0.7 else \
                rng.integers(0, 4, int(rng.integers(1, 41)))
            rows.append(r)
            orients.append(o)
            seqs.append(s)
            cols.append(int(rng.integers(0, 2)))
    Jmax = max(len(s) for s in seqs)
    bases = np.zeros((len(seqs), Jmax), np.uint8)
    for i, s in enumerate(seqs):
        bases[i, :len(s)] = s
    nj = np.array([len(s) for s in seqs], np.int64)
    return (np.array(rows), np.array(orients), bases, nj, np.array(cols))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The golden pair, and a three-colour graph (X, Y, Z) with a
    two-colour link file of random links written by the JAX package."""
    d = tmp_path_factory.mktemp("ctp")
    p = {"d": d, "g": os.path.join(GOLD, "g.ctx"),
         "l": os.path.join(GOLD, "l.ctp.gz")}
    seqs = [random_dna(150, seed=600 + i) for i in range(3)]
    args = []
    for name, s in zip("XYZ", seqs):
        fa = str(d / f"{name}.fa")
        write_fasta(fa, [s, seqs[0][40:100]])
        args += ["-s", name, "--seq", fa]
    p["g3"] = str(d / "g3.ctx")
    assert port_main(["build", "-k", str(K)] + args
                     + ["-q", p["g3"], "--device", "cpu"]) == 0
    _h, jg = jload(p["g3"])
    p["recs"] = _random_links(int(jg.n))
    p["links"] = str(d / "links.ctp.gz")
    jctp.save_ctp(p["links"], jg, jls.build_store(jg.keys, *p["recs"],
                                                   ncols=2),
                  sample_names=["X", "Y"], contig_hists=[{60: 3, 150: 2}])
    # the same file, not compressed
    p["links_txt"] = str(d / "links.ctp")
    with open(p["links_txt"], "w") as fh:
        fh.write(gzip.open(p["links"], "rt").read())
    return p


def _host(ls):
    """A LinkStore's arrays as numpy, unsigned where the port carries
    bit views."""
    if isinstance(ls.offsets, torch.Tensor):
        return tls.to_host(ls)
    return tuple(np.asarray(a) for a in (ls.offsets, ls.seq, ls.nj,
                                         ls.nseen))


def _stores_equal(got, want):
    for a, b, name in zip(_host(got), _host(want),
                          ("offsets", "seq", "nj", "nseen")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _text(path):
    """Decompressed .ctp text with the generator value masked."""
    text = gzip.open(path, "rt").read()
    masked = re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)
    assert masked.count('"generator": "-"') == 1
    return masked


def _graphs(path):
    return jload(path)[1], tload(path, "cpu")[1]


@pytest.mark.parametrize("which", [("g", "l"), ("g3", "links")])
def test_load_ctp_matches_jax(files, which):
    jg, tg = _graphs(files[which[0]])
    want = jctp.load_ctp(files[which[1]], jg)
    got = tctp.load_ctp(files[which[1]], tg)
    _stores_equal(got, want)
    assert got.offsets.device.type == "cpu"
    assert tctp.load_ctp_header(files[which[1]]) == \
        jctp.load_ctp_header(files[which[1]])
    hdr = jctp.load_ctp_header(files[which[1]])
    for c in range(3):
        assert tctp.contig_hist_from_header(hdr, c) == \
            jctp.contig_hist_from_header(hdr, c)
    if which[1] == "links":
        assert got.nlinks > 40 and got.jwords == 2


def test_build_store_and_unpack_match_jax(files):
    jg, tg = _graphs(files["g3"])
    want = jls.build_store(jg.keys, *files["recs"], ncols=2)
    got = tls.build_store(tg.keys, *files["recs"], ncols=2)
    _stores_equal(got, want)
    pos = np.random.default_rng(1).integers(0, 64, got.nlinks)
    np.testing.assert_array_equal(
        tls.unpack_junc(got.seq, torch.from_numpy(pos)).numpy(),
        np.asarray(jls.unpack_junc(want.seq, jnp.asarray(pos))))
    _stores_equal(tls.empty(5, 3, 2, "cpu"), jls.empty(5, 3, 2))


@pytest.mark.parametrize("ncols", [1, 2])
def test_save_ctp_matches_jax(files, tmp_path, ncols):
    """save_ctp of the loaded store (and of one colour of it), with
    sample names and contig histograms: the same text as JAX's."""
    jg, tg = _graphs(files["g3"])
    jl = jctp.load_ctp(files["links"], jg)
    tl = tctp.load_ctp(files["links"], tg)
    if ncols == 1:
        jl = jl.replace(nseen=jl.nseen[:, :1])
        tl = tls.LinkStore(tl.offsets, tl.seq, tl.nj, tl.nseen[:, :1])
    kw = dict(sample_names=["X", "Y"], command="mctx pjoin",
              contig_hists=[{100: 4}, {7: 1, 300: 2}],
              prev_commands=[{"cmd": "mctx thread", "date": "d"}])
    a, b = str(tmp_path / "j.ctp.gz"), str(tmp_path / "t.ctp.gz")
    jctp.save_ctp(a, jg, jl, **kw)
    tctp.save_ctp(b, tg, tl, **kw)
    assert _text(b) == _text(a)
    assert '"generator": "mccortex_tpu_torch ' in gzip.open(b, "rt").read()


PJOIN_CASES = {
    "golden": ["GRAPH_g", "LINKS_l"],
    "one": ["GRAPH_g3", "LINKS_links"],
    "noredundant": ["-r", "GRAPH_g3", "LINKS_links"],
    "outcols3": ["-c", "3", "GRAPH_g3", "LINKS_links"],
    "self": ["GRAPH_g3", "LINKS_links", "LINKS_links"],
    "self_r_g": ["-r", "-g", "GRAPH_g3", "LINKS_links", "LINKS_links"],
}


@pytest.mark.parametrize("case", list(PJOIN_CASES))
def test_pjoin_matches_mctx(files, capsys, case):
    args = [files[a.split("_", 1)[1]] if a.startswith(("GRAPH_", "LINKS_"))
            else a for a in PJOIN_CASES[case]]
    outs, errs = [], []
    for side, run in (("j", mctx_main),
                      ("t", lambda a: port_main(a + ["--device", "cpu"]))):
        out = str(files["d"] / f"pjoin_{case}_{side}.ctp.gz")
        capsys.readouterr()
        assert run(["pjoin", "-o", out] + args) == 0
        outs.append(_text(out))
        errs.append([l for l in capsys.readouterr().err.splitlines()
                     if l.startswith(("[mctx] merged", "[mctx] noredundant"))])
    assert outs[1] == outs[0]
    assert errs[1] == errs[0] and errs[0]
    if case == "noredundant":
        assert re.search(r"noredundant: (\d+) -> (\d+)", errs[0][0]).group(1) \
            != re.search(r"-> (\d+) links", errs[0][0]).group(1)


def test_pjoin_refuses_more_colours_than_the_graph(files, capsys):
    """Reference fault, not copied: `mctx pjoin -c N` with N above the
    graph's colours fails on an IndexError (a sample name per output
    colour, from the graph); the port refuses it with a message."""
    out = str(files["d"] / "pjoin_c4.ctp.gz")
    with pytest.raises(IndexError):
        mctx_main(["pjoin", "-c", "4", "-o", out, files["g3"],
                   files["links"]])
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        port_main(["pjoin", "-c", "4", "-o", out, files["g3"],
                   files["links"], "--device", "cpu"])
    assert e.value.code == 2 and not os.path.exists(out)
    assert "graph colours" in capsys.readouterr().err


@pytest.mark.parametrize("which", ["l", "links", "links_txt"])
def test_pview_matches_mctx(files, capsys, which):
    outs = []
    for run in (mctx_main, port_main):
        capsys.readouterr()
        assert run(["pview", files["g"], files[which]]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[0].startswith("{")


def _prefix_store(mod, tensor, seqs, ncols=1, counts=None):
    """One vertex (0) of a 4-kmer graph holding the links `seqs`."""
    juncs = np.zeros((len(seqs), 4), np.uint8)
    for i, s in enumerate(seqs):
        juncs[i, :len(s)] = ["ACGT".index(c) for c in s]
    nj = np.array([len(s) for s in seqs])
    packed = jls.pack_juncs(juncs, nj, 1)
    nseen = (np.ones((len(seqs), ncols), np.uint32) if counts is None
             else np.asarray(counts, np.uint32))
    offsets = np.concatenate([[0], [len(seqs)] * 8]).astype(np.int32)
    if mod is tls:
        return tls.from_host(offsets, packed, nj, nseen, "cpu")
    return jls.LinkStore(offsets=jnp.asarray(offsets),
                         seq=jnp.asarray(packed),
                         nj=jnp.asarray(nj.astype(np.int32)),
                         nseen=jnp.asarray(nseen))


RMSUBSTR_CASES = {
    "prefixes": (["A", "C", "CG", "CGC"], None),
    "duplicates": (["CG", "CG", "A", "CGT"], [[1, 0], [2, 0], [0, 5],
                                               [0, 1]]),
    "colours_kept": (["C", "CG", "CGT", "G"], [[1, 1], [0, 1], [1, 0],
                                                [3, 3]]),
}


@pytest.mark.parametrize("case", list(RMSUBSTR_CASES))
def test_rmsubstr_and_merge_match_jax(case):
    """The cases of tests/test_cli_flags.py::
    test_rmsubstr_store_prefix_removal and two more: rmsubstr_store, and
    merge_stores of the store with itself and with a one-colour store."""
    seqs, counts = RMSUBSTR_CASES[case]
    ncols = 1 if counts is None else 2
    j = _prefix_store(jls, jnp.asarray, seqs, ncols, counts)
    t = _prefix_store(tls, torch.from_numpy, seqs, ncols, counts)
    _stores_equal(t, j)
    _stores_equal(tls.rmsubstr_store(t), jls.rmsubstr_store(j))
    if case == "prefixes":
        assert tls.rmsubstr_store(t).nlinks == 2
    j1 = _prefix_store(jls, jnp.asarray, ["A", "GT"])
    t1 = _prefix_store(tls, torch.from_numpy, ["A", "GT"])
    _stores_equal(tls.merge_stores(t, t, 4), jls.merge_stores(j, j, 4))
    _stores_equal(tls.merge_stores(t1, t, 4), jls.merge_stores(j1, j, 4))


def test_strings_to_kmers_is_a_copy():
    rng = np.random.default_rng(5)
    for k, W in ((11, 1), (33, 2), (63, 2)):
        strs = ["".join("ACGT"[b] for b in rng.integers(0, 4, k))
                for _ in range(20)]
        want = jtext.strings_to_kmers(strs, W)
        got = ttext.strings_to_kmers(strs, W)
        np.testing.assert_array_equal(got, want)
        assert ttext.kmers_to_strings(got, k) == strs
    mixed = ["ACG", "ACGTA"]
    np.testing.assert_array_equal(ttext.strings_to_kmers(mixed, 1),
                                  jtext.strings_to_kmers(mixed, 1))

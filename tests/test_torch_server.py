"""`mctx-torch server`, `exp_abc` and `hashtest` and the port's
io/ctx.DiskGraphReader against mccortex_tpu on the CPU: the same JSON
replies byte for byte (but for the kmer `random` picks), the same
RES_* counts and -P output, the same inserted kmer count and unique
keys.  Every graph and link file is made once by `mctx`.
"""

import io
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import build as jbuild
from mccortex_tpu.io import ctx as jctx
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.io import ctx as tctx

from test_ctx_io import write_fasta
from util import random_dna


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """k = 9: two reads sharing 40 bases, their links and block index;
    k = 63: one 400 bp read and its index; k = 11: the genome of
    test_commands2.py::test_exp_abc read twice, and its links."""
    d = tmp_path_factory.mktemp("server")
    m = random_dna(40, seed=1000)
    r1 = random_dna(25, seed=1001) + m + random_dna(25, seed=1002)
    r2 = random_dna(25, seed=1003) + m + random_dna(25, seed=1004)
    genome = random_dna(400, seed=1700)
    f = {"d": d, "reads": (r1, r2)}
    for name, k, seqs in (("k9", 9, [r1, r2]),
                          ("k63", 63, [random_dna(400, seed=2200)]),
                          ("abc", 11, [genome] * 2)):
        fa = str(d / f"{name}.fa")
        write_fasta(fa, seqs)
        f[name] = str(d / f"{name}.ctx")
        assert mctx_main(["build", "-q", "-k", str(k), "--sample", "s",
                          "--seq", fa, f[name]]) == 0
        if name != "k63":
            f[name + ".ctp"] = str(d / f"{name}.ctp.gz")
            assert mctx_main(["thread", "-q", "--no-gap-fill", "--seq", fa,
                              "-o", f[name + ".ctp"], f[name]]) == 0
        if name != "abc":
            assert mctx_main(["index", "-q", f[name]]) == 0
    return f


@pytest.mark.parametrize("with_idx", [True, False])
@pytest.mark.parametrize("name", ["k9", "k63"])
def test_disk_reader_matches_original(files, name, with_idx):
    path = files[name]
    idx = None if with_idx else str(files["d"] / "no.idx")
    _h, keys, _c, _e = jctx.read_ctx(path)
    rng = np.random.default_rng(8)
    absent = rng.integers(0, 1 << 62, size=(30, keys.shape[1]),
                          dtype=np.uint64)
    want_reader = jctx.DiskGraphReader(path, idx, block_kmers=16)
    with tctx.DiskGraphReader(path, idx, block_kmers=16) as got_reader:
        assert got_reader.n == want_reader.n == len(keys)
        np.testing.assert_array_equal(got_reader.block_starts,
                                      want_reader.block_starts)
        nfound = 0
        for key in np.concatenate([keys, absent]):
            want, got = want_reader.lookup(key), got_reader.lookup(key)
            assert (got is None) == (want is None)
            if want is not None:
                nfound += 1
                assert got[0] == want[0]
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_array_equal(got[2], want[2])
    want_reader.close()
    assert nfound == len(keys)
    if with_idx:
        assert len(want_reader.block_starts) < len(keys)


def _queries(files):
    r1, r2 = files["reads"]
    present = [r1[i:i + 9] for i in (0, 30, 81)] + [r2[5:14].lower()]
    return (["info"] + present + [random_dna(9, seed=7), "NNNNNNNNN",
                                  "ACGT", "", "ACGTACGTACGTX"]
            + [r2[60:69]])


def _linked_kmers(files):
    """Two kmers of the k = 9 graph that carry links."""
    from mccortex_tpu_torch.cli.commands import _load_graph
    from mccortex_tpu_torch.io import ctp as tctp
    from mccortex_tpu_torch.links.walk import link_vertices
    from mccortex_tpu_torch.utils.text import kmers_to_strings
    g = _load_graph(files["k9"], "cpu")[1]
    lv = link_vertices(tctp.load_link_store([files["k9.ctp"]], g), g.n)
    rows = np.unique(lv >> 1)[:2]
    return kmers_to_strings(g.keys[rows].numpy().view(np.uint64), g.k)


def _serve(capsys, monkeypatch, run, argv, lines):
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    capsys.readouterr()
    rc = run(argv)
    return rc, capsys.readouterr().out


SERVER = {"plain": [], "C_E": ["-C", "-E"], "links": ["-p", "CTP"],
          "disk": ["--disk"]}


@pytest.mark.parametrize("case", list(SERVER))
def test_server_replies_match_mctx(files, capsys, monkeypatch, case):
    argv = ["server"] + [files["k9.ctp"] if a == "CTP" else a
                         for a in SERVER[case]] + [files["k9"]]
    lines = _queries(files) + (_linked_kmers(files) if case == "links"
                               else [])
    jrc, jout = _serve(capsys, monkeypatch, mctx_main, argv, lines)
    trc, tout = _serve(capsys, monkeypatch, port_main,
                       argv + ["--device", "cpu"], lines)
    assert jrc == trc == 0
    assert tout == jout
    assert tout.count('"error"') == 3
    assert tout.count('"find": true') == 5 + 2 * (case == "links")
    if case == "links":
        assert tout.count('"juncs": "') >= 2


def test_server_random_is_a_graph_kmer(files, capsys, monkeypatch):
    import json
    rc, out = _serve(capsys, monkeypatch, port_main,
                     ["server", files["k9"], "--device", "cpu"],
                     ["random"] * 5)
    assert rc == 0
    replies = [json.loads(line) for line in out.splitlines()]
    assert len(replies) == 5 and all(r["find"] for r in replies)


def test_server_disk_refuses_links(files, capsys):
    argv = ["server", "--disk", "-p", files["k9.ctp"], files["k9"]]
    for run in (mctx_main, lambda a: port_main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            run(argv)
        assert e.value.code == 2
        assert "--disk serves the graph only" in capsys.readouterr().err


def test_exp_abc_matches_mctx(files, capsys):
    argv = ["exp_abc", "-N", "50", "-P", "-p", files["abc.ctp"],
            files["abc"]]
    res = []
    for run in (mctx_main, lambda a: port_main(a + ["--device", "cpu"])):
        capsys.readouterr()
        assert run(argv) == 0
        cap = capsys.readouterr()
        res.append((cap.out, [line for line in cap.err.splitlines()
                              if "RES_" in line]))
    assert res[0] == res[1]
    counts = [int(re.search(r": (\d+) /", line).group(1))
              for line in res[1][1]]
    assert len(counts) == 5 and sum(counts) == 50 and counts[0] >= 40


@pytest.mark.parametrize("k", [11, 31])
def test_hashtest_counts_match_mctx(capsys, k):
    res = []
    for run in (mctx_main, lambda a: port_main(a + ["--device", "cpu"])):
        capsys.readouterr()
        assert run(["hashtest", "-n", "4096", "-k", str(k)]) == 0
        res.append(capsys.readouterr().err)
    nk = [re.search(r"insert: (\d+) kmers", e).group(1) for e in res]
    assert nk[0] == nk[1] and re.search(r"lookup: 4096 queries", res[1])
    # the unique keys of mctx's insert: its epoch on the same draws
    bases = np.random.default_rng(0).integers(
        0, 4, size=(max(4096 // (256 - k + 1), 1), 256), dtype=np.uint8)
    nu = int(jbuild.count_batch(jnp.asarray(bases), k, 1, 0)[3])
    assert f"({nu} unique)" in res[1]


def test_command_table_matches_mctx(capsys):
    """`mctx-torch` with no arguments lists mctx's 31 commands."""
    names = []
    for run in (mctx_main, port_main):
        capsys.readouterr()
        assert run([]) == 0
        names.append(re.findall(r"^  (\S+)", capsys.readouterr().out, re.M))
    assert names[0] == names[1] and len(names[0]) == 31

"""The port's graph phases and their commands against mccortex_tpu on the
CPU: infer_edges (--pop, --all), bfs_mark, subgraph (--invert,
--unitigs), the contig confidence table, and `mctx-torch contigs |
inferedges | subgraph ... --device cpu` against `mctx` on the same
inputs (the two-colour graph of tests/test_commands2.py: B is A with 50
bases inserted).  Output bytes, text and status lines: exact equality.
"""

import io

import numpy as np
import pytest

from mccortex_tpu.cli.commands import _load_graph as jload
from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import contig_confidence as jcc
from mccortex_tpu.graph import infer_edges as jie
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.graph import subgraph as jsg
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import contig_confidence as tcc
from mccortex_tpu_torch.graph import infer_edges as tie
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.graph import subgraph as tsg

from test_ctx_io import write_fasta
from test_torch_unitigs import port_graph
from util import random_dna, seq_to_codes

K = 11
A = random_dna(200, seed=500)
B = A[:100] + random_dna(50, seed=501) + A[100:]
# colour 1 holds every kmer of colour 0 but misses the edge from A[89:100]
# to A[90:101] (and from the 'N' splits): the edges --pop infers
SPLIT = [(A, 0), (A[:100], 1), (A[90:160] + "N" + A[160:], 1)]


def _port(argv):
    return port_main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_cmds")
    p = {"d": d}
    for name, seqs in (("a", [A]), ("b", [B]),
                       ("split", [s for s, c in SPLIT if c == 1]),
                       ("seed", [A[50:50 + K]]),
                       ("seeds", [A[10:10 + K], B[120:120 + K],
                                  "ACGTACGTACG", A[150:150 + K]])):
        p[name + ".fa"] = str(d / f"{name}.fa")
        write_fasta(p[name + ".fa"], seqs)
    for name, args in (("ab", ["-s", "A", "--seq", p["a.fa"], "-s", "B",
                               "--seq", p["b.fa"]]),
                       ("a", ["-s", "A", "--seq", p["a.fa"]]),
                       ("b", ["-s", "B", "--seq", p["b.fa"]]),
                       ("split", ["-s", "A", "--seq", p["a.fa"], "-s", "S",
                                  "--seq", p["split.fa"]])):
        p[name] = str(d / f"{name}.ctx")
        assert _port(["build", "-k", str(K)] + args + ["-q", p[name]]) == 0
    return p


def _both(capsys, argv, d, name):
    """`mctx argv` and `mctx-torch argv --device cpu`, each with its own
    files for the words OUT and CSV of argv (d/name_{j,t}.out, .csv).
    Returns ((rc, stderr, OUT path) of mctx, the same of the port)."""
    res = []
    for side, run in (("j", mctx_main), ("t", _port)):
        paths = {"OUT": str(d / f"{name}_{side}.out"),
                 "CSV": str(d / f"{name}_{side}.csv")}
        capsys.readouterr()
        rc = run([paths.get(a, a) for a in argv])
        res.append((rc, capsys.readouterr().err, paths["OUT"]))
    return res


def _lines(err, prefix):
    return [l for l in err.splitlines() if l.startswith(prefix)]


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph(files):
    """The two-colour graph as the JAX package loads it, carried across."""
    jg = jload(files["ab"])[1]
    return jg, port_graph(jg)


@pytest.fixture(scope="module")
def split_graph(files):
    jg = jload(files["split"])[1]
    return jg, port_graph(jg)


def _store_equal(tg, jg):
    got, want = tstore.to_host(tg), jstore.to_host(jg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tg.n == int(jg.n)


@pytest.mark.parametrize("pop_only", [True, False])
def test_infer_edges_matches_jax(split_graph, pop_only):
    jg, tg = split_graph
    j2 = jie.infer_edges(jg, pop_only=pop_only)
    t2 = tie.infer_edges(tg, pop_only=pop_only)
    np.testing.assert_array_equal(t2.edges.numpy(), np.asarray(j2.edges))
    assert (t2.edges != tg.edges).any()         # something was inferred


def _seed_batches(seqs):
    L = max(len(s) for s in seqs)
    return [np.stack([seq_to_codes(s, pad_to=L) for s in seqs])]


@pytest.mark.parametrize("dist", [0, 1, 5])
def test_bfs_mark_matches_jax(graph, dist):
    jg, tg = graph
    batches = _seed_batches([A[50:50 + K], B[110:110 + 2 * K]])
    jm = jsg.seed_mask_from_seqs(jg, batches)
    tm = tsg.seed_mask_from_seqs(tg, batches)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) == 1 + K + 1
    want = np.asarray(jsg.bfs_mark(jg, jm, dist, K))
    np.testing.assert_array_equal(tsg.bfs_mark(tg, tm, dist, K).numpy(),
                                  want)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("whole", [False, True])
def test_subgraph_matches_jax(graph, invert, whole):
    jg, tg = graph
    batches = _seed_batches([A[50:50 + K]])
    for dist in (0, 5):
        _store_equal(tsg.subgraph(tg, batches, dist=dist, invert=invert,
                                  whole_unitigs=whole),
                     jsg.subgraph(jg, batches, dist=dist, invert=invert,
                                  whole_unitigs=whole))


def test_confidence_table_is_a_copy():
    hist = {100: 1000, 60: 40, 150: 7}
    want = jcc.conf_table(10000, hist)
    got = tcc.conf_table(10000, hist)
    np.testing.assert_array_equal(got, want)
    a, b = io.StringIO(), io.StringIO()
    tcc.print_table(got, a)
    jcc.print_table(want, b)
    assert a.getvalue() == b.getvalue()
    assert tcc.calc_confid(3.5, 100, 20) == jcc.calc_confid(3.5, 100, 20)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

CONTIG_CASES = {
    "default": ["OUT"],
    "N1_reseed": ["OUT", "-N", "1", "-r"],
    "seed": ["OUT", "-s", "SEEDS", "--batch", "3"],
    "max_len": ["OUT", "--max-len", "50"],
    "genome_csv": ["OUT", "-G", "10000", "-S", "CSV"],
}


@pytest.mark.parametrize("case", list(CONTIG_CASES))
def test_contigs_matches_mctx(files, capsys, case):
    d = files["d"]
    args = [files["seeds.fa"] if a == "SEEDS" else a
            for a in CONTIG_CASES[case]]
    (rj, ej, fj), (rt, et, ft) = _both(
        capsys, ["contigs", "-o"] + args + [files["ab"]], d, f"c_{case}")
    assert rj == rt == 0
    fa = open(fj, "rb").read()
    assert open(ft, "rb").read() == fa and fa.count(b">contig") >= 1
    if "CSV" in args:
        assert open(fj[:-4] + ".csv").read() == open(ft[:-4] + ".csv").read()
    assert _lines(et, "[mctx] contigs:")
    for prefix in ("[mctx] contigs:", "[mctx] contigs halt reasons:",
                   "[mctx] contigs: 1 seed kmers not found"):
        assert _lines(et, prefix) == _lines(ej, prefix)
    if case == "max_len":
        assert "HitMaxLen" in _lines(et, "[mctx] contigs halt")[0]


# --devices 2 on the CPU: the linkless walkers split over two replicas
# of the graph, the linked walk (-p) on one device, as in mctx; either way
# the one-device FASTA
@pytest.mark.parametrize("flags", [["-p", "LINKS"], ["-P"], []])
def test_contigs_devices_2_writes_the_one_device_fasta(files, capsys, flags):
    links = str(files["d"] / "devices_links.ctp.gz")
    if not (files["d"] / "devices_links.ctp.gz").exists():
        assert _port(["thread", "-q", "--seq", files["b.fa"], "-o", links,
                      files["ab"]]) == 0
    case = "".join(f.strip("-") for f in flags) or "linkless"
    flags = [links if f == "LINKS" else f for f in flags]
    outs = []
    for tag, extra in (("one", []), ("two", ["--devices", "2"])):
        out = str(files["d"] / f"contigs_devices_{case}_{tag}.fa")
        capsys.readouterr()
        assert _port(["contigs", "--batch", "8", "-o", out] + flags + extra
                     + [files["ab"]]) == 0
        err = capsys.readouterr().err
        outs.append(open(out).read())
    assert outs[0] == outs[1] and outs[0].count(">contig") > 1
    assert "contigs: walkers sharded over 2 devices" in err


def test_contigs_confid_without_links_fails_as_mctx(files, capsys):
    argv = ["contigs", "-G", "10000", "-C", "0.5", files["ab"]]
    errs = []
    for run in (mctx_main, _port):
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            run(list(argv))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0].endswith("--confid-* need -p link files")
    assert errs[1].endswith("--confid-* need -p link files")


@pytest.mark.parametrize("mode", ["--pop", "--all"])
def test_inferedges_matches_mctx(files, capsys, mode):
    (rj, ej, a), (rt, et, b) = _both(
        capsys, ["inferedges", mode, "-o", "OUT", files["split"]], files["d"],
        f"inf{mode}")
    assert rj == rt == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    assert _lines(et, "[mctx] inferred") == _lines(ej, "[mctx] inferred")
    assert _lines(et, "[mctx] inferred") != \
        ["[mctx] inferred edges: 0 edge bytes changed"]


SUBGRAPH_CASES = {
    "dist5": ["--dist", "5"],
    "invert": ["--dist", "5", "--invert"],
    "unitigs": ["-U", "--dist", "1"],
    "two_graphs": ["--dist", "5", "GRAPH_B"],
}


@pytest.mark.parametrize("case", list(SUBGRAPH_CASES))
def test_subgraph_matches_mctx(files, capsys, case):
    d = files["d"]
    extra = SUBGRAPH_CASES[case]
    graphs = ([files["a"], files["b"]] if "GRAPH_B" in extra
              else [files["ab"]])
    flags = [a for a in extra if a != "GRAPH_B"]
    (rj, ej, a), (rt, et, b) = _both(
        capsys, ["subgraph", "--seq", files["seed.fa"]] + flags
        + ["-o", "OUT"] + graphs, d, f"sub_{case}")
    assert rj == rt == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    assert _lines(et, "[mctx] subgraph") == _lines(ej, "[mctx] subgraph")

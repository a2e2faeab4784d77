"""The port's reference-position index (mccortex_tpu_torch.graph.
kmer_occur) against mccortex_tpu.graph.kmer_occur on the CPU: RefGenome,
build_kograph (the CSR of occurrences), occurs, occurs_mask and
runs_of_path on the same graph and genome.  Exact equality."""

import numpy as np
import pytest
import torch

from mccortex_tpu.cli.commands import _load_graph as jload
from mccortex_tpu.graph import kmer_occur as jko
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.constants import CHAR_TO_BASE
from mccortex_tpu_torch.graph import kmer_occur as tko
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.io import ctx as tctx
from mccortex_tpu_torch.ops import hashidx as thashidx
from mccortex_tpu_torch.ops import kmer as tkops


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module", params=[11, 31])
def case(request, tmp_path_factory):
    """A genome of three chromosomes (a repeat shared by two, one shorter
    than k, an N), and the graph of reads of it plus foreign sequence,
    loaded in both packages."""
    k = request.param
    d = tmp_path_factory.mktemp(f"ko{k}")
    rng = np.random.default_rng(k)
    rep = _dna(rng, 90)
    chroms = [_dna(rng, 700) + rep + _dna(rng, 400) + rep,
              _dna(rng, 300) + "N" + _rc(rep) + _dna(rng, 250),
              _dna(rng, k - 2)]
    ref = d / "ref.fa"
    with open(ref, "w") as fh:
        for i, c in enumerate(chroms):
            fh.write(f">chr{i} desc\n")
            for j in range(0, len(c), 60):
                fh.write(c[j:j + 60] + "\n")
    reads = d / "reads.fa"
    with open(reads, "w") as fh:
        for i in range(120):
            c = chroms[i % 2]
            s = int(rng.integers(0, len(c) - 100))
            r = c[s:s + 100]
            fh.write(f">r{i}\n{r if i % 3 else _rc(r)}\n")
        fh.write(f">foreign\n{_dna(rng, 200)}\n")
    ctx = d / "g.ctx"
    assert port_main(["build", "-k", str(k), "-s", "g", "--seq", str(reads),
                      "--device", "cpu", "-q", str(ctx)]) == 0
    _h, keys, covg, edges = tctx.read_ctx(str(ctx))
    tg = tstore.from_host(keys, covg, edges, k, "cpu")
    _jh, jg = jload(str(ctx))
    return dict(k=k, ref=str(ref), chroms=chroms, tg=tg, jg=jg)


def test_ref_genome_matches_jax(case):
    t = tko.RefGenome.from_fasta(case["ref"])
    j = jko.RefGenome.from_fasta(case["ref"])
    assert (t.names, t.seqs) == (j.names, j.seqs)
    assert t.names == ["chr0", "chr1", "chr2"]
    assert t.as_dict() == dict(zip(j.names, j.seqs))


def test_build_kograph_matches_jax(case):
    ref = tko.RefGenome.from_fasta(case["ref"])
    t = tko.build_kograph(case["tg"], ref)
    j = jko.build_kograph(case["jg"], jko.RefGenome.from_fasta(case["ref"]))
    for name in ("offsets", "chrom", "pos", "orient"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t.noccurs == j.noccurs > 0
    # the repeat: some rows occur more than once, on both strands
    counts = np.diff(t.offsets.numpy())
    assert counts.max() >= 3 and set(t.orient.tolist()) == {0, 1}
    rows = np.arange(case["tg"].capacity)
    np.testing.assert_array_equal(tko.occurs(t, rows),
                                  jko.occurs(j, rows))
    np.testing.assert_array_equal(tko.occurs_mask(t, len(rows)),
                                  jko.occurs_mask(j, len(rows)))
    assert not tko.occurs_mask(t, len(rows)).all()   # foreign kmers


def test_build_kograph_with_no_hit_matches_jax(case):
    rng = np.random.default_rng(5)
    ref = tko.RefGenome(["x", "y"], [_dna(rng, 300), "ACG"])
    t = tko.build_kograph(case["tg"], ref)
    j = jko.build_kograph(case["jg"], jko.RefGenome(ref.names, ref.seqs))
    assert t.noccurs == j.noccurs
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    empty = tko.build_kograph(case["tg"], tko.RefGenome(["s"], ["ACG"]))
    assert empty.noccurs == 0 and empty.offsets.shape[0] == \
        case["tg"].capacity + 1


def _verts(g, seq):
    """Vertex path (2*row + orientation) of a sequence's kmers, those in
    the graph only."""
    codes = torch.from_numpy(CHAR_TO_BASE[np.frombuffer(seq.encode(),
                                                        np.uint8)][None])
    kmers, valid = tkops.rolling_kmers(codes, g.k)
    keys, orient = tkops.canonical(kmers[0], g.k)
    idx, found = thashidx.lookup(g.keys, keys)
    ok = (valid[0] & found).numpy()
    return (2 * idx.numpy().astype(np.int64) + orient.numpy())[ok]


@pytest.mark.parametrize("min_len", [1, 5])
def test_runs_of_path_matches_jax(case, min_len):
    c0, c1, _ = case["chroms"]
    t = tko.build_kograph(case["tg"], tko.RefGenome.from_fasta(case["ref"]))
    j = jko.build_kograph(case["jg"], jko.RefGenome.from_fasta(case["ref"]))
    paths = [c0[100:400], _rc(c0[600:900]), c0[650:700] + c1[20:120],
             c1[290:500], c0[1150:]]
    nruns = 0
    for seq in paths:
        verts = _verts(case["tg"], seq)
        want = jko.runs_of_path(j, verts, min_len)
        assert tko.runs_of_path(t, verts, min_len) == want
        nruns += len(want)
    assert nruns >= len(paths)

"""The port's build path (mccortex_tpu_torch.graph, .io, .cli) against
mccortex_tpu on the same numpy-seeded inputs, on the CPU (where every
kernel wrapper takes its plain version).  Integer outputs and file
bytes: exact equality, no tolerance."""

import gzip
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.graph import build as jb
from mccortex_tpu.graph import store as jstore
from mccortex_tpu.io import ctx as jctx
from mccortex_tpu.io import seqio as jseqio
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.io import ctx as tctx
from mccortex_tpu_torch.io import seqio as tseqio

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _reads(seed, B, L, n_frac=0.01):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < n_frac] = 4
    return bases


def _host_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [11, 21, 31, 33, 63, 95])
def test_count_batch_matches_jax(k):
    bases = _reads(2000 + k, 16, 120)
    bases[3, 50:] = 4
    jk, jc, je, jn = jb.count_batch(jnp.asarray(bases), k, 3, 1)
    tk, tc, te, tn = tb.count_batch(torch.from_numpy(bases), k, 3, 1)
    assert tn == int(jn) > 0
    np.testing.assert_array_equal(tk.numpy().view(np.uint64), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("fq,hp", [(10, 0), (0, 4), (20, 3)])
def test_mask_reads_matches_jax(fq, hp):
    rng = np.random.default_rng(fq * 10 + hp)
    bases = rng.integers(0, 3, size=(20, 80)).astype(np.uint8)   # runs
    bases[rng.random(bases.shape) < 0.02] = 4
    quals = rng.integers(0, 41, size=bases.shape).astype(np.uint8)
    want = jb.mask_reads(jnp.asarray(bases), jnp.asarray(quals), fq, hp)
    got = tb.mask_reads(torch.from_numpy(bases), torch.from_numpy(quals),
                        fq, hp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batches(n_batches, ncols, k):
    """A genome's reads spread over n_batches batches and ncols colours
    (shared kmers across batches, so merges combine records)."""
    rng = np.random.default_rng(3000 + k)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for i in range(n_batches):
        starts = rng.integers(0, len(genome) - 70, 8)
        b = np.stack([genome[s:s + 70] for s in starts])
        b[rng.random(b.shape) < 0.01] = 4
        out.append((b, i % ncols))
    return out


@pytest.fixture(scope="module")
def lsm_case():
    """40 batches over 2 colours at k=31, and mctx_tpu's graph of them."""
    batches = _batches(40, 2, 31)
    return batches, jstore.to_host(jb.build(batches, 31, ncols=2))


def test_build_matches_jax_over_lsm_levels(lsm_case):
    batches, want = lsm_case
    g = tb.build(batches, 31, ncols=2, device="cpu")
    assert g.n == len(want[0]) and g.device.type == "cpu"
    _host_equal(tstore.to_host(g), want)


def test_build_single_batch_and_empty():
    batches = _batches(1, 1, 31)
    want = jstore.to_host(jb.build(batches, 31, ncols=1))
    _host_equal(tstore.to_host(tb.build(batches, 31, device="cpu")), want)
    g = tb.build([], 31, ncols=2, device="cpu")
    assert g.n == 0 and g.ncols == 2 and g.W == 1


def test_from_host_round_trip_of_jax_graph(lsm_case):
    _batches_, want = lsm_case
    g = tstore.from_host(*want, k=31, device="cpu")
    assert g.n == len(want[0]) and g.ncols == 2
    _host_equal(tstore.to_host(g), want)
    assert tstore.compacted(g) is g            # already at its live size


def test_empty_and_compacted_store():
    e = tstore.empty(31, 100, 2)
    assert e.n == 0 and e.capacity == 100 and (e.keys == -1).all()
    c = tstore.compacted(e, align=16)
    assert c.capacity == 16 and c.ncols == 2 and c.W == 1


def _ctx_records(seed, n, W, C):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**62, size=(n, W), dtype=np.uint64),
                     axis=0)
    covg = rng.integers(0, 5, size=(len(keys), C)).astype(np.uint32)
    edges = rng.integers(0, 256, size=(len(keys), C)).astype(np.uint8)
    return keys, covg, edges


@pytest.mark.parametrize("k,C", [(31, 1), (63, 3)])
def test_ctx_io_matches_original(tmp_path, k, C):
    def header(mod):
        gi = [mod.GraphInfo(sample_name=f"s{c}", total_sequence=1000 + c,
                            mean_read_length=100 + c, seq_err=0.02)
              for c in range(C)]
        gi[0].cleaning.cleaned_tips = True
        gi[0].cleaning.clean_kmers_thresh = 3
        return mod.CtxHeader(kmer_size=k, ginfo=gi)

    keys, covg, edges = _ctx_records(k + C, 500, (2 * k + 63) // 64, C)
    a, b = tmp_path / "jax.ctx", tmp_path / "port.ctx"
    jctx.write_ctx(str(a), header(jctx), keys, covg, edges)
    tctx.write_ctx(str(b), header(tctx), keys, covg, edges)
    assert a.read_bytes() == b.read_bytes()
    gz = tmp_path / "port.ctx.gz"
    gz.write_bytes(gzip.compress(b.read_bytes()))
    jh, *jrec = jctx.read_ctx(str(a))
    for path in (b, gz):
        th, *trec = tctx.read_ctx(str(path))
        assert th.kmer_size == jh.kmer_size and th.ncols == jh.ncols
        assert [g.sample_name for g in th.ginfo] == \
            [g.sample_name for g in jh.ginfo]
        _host_equal(trec, jrec)


def _write_inputs(tmp_path):
    rng = np.random.default_rng(4000)
    seq = lambda n: "".join("ACGTN"[i] for i in rng.choice(
        5, n, p=[0.245, 0.245, 0.245, 0.245, 0.02]))
    fa = tmp_path / "r.fa"
    with open(fa, "w") as f:
        for i, n in enumerate([60, 150, 1500, 40, 2100, 90]):
            s = seq(n)
            f.write(f">read{i} desc\n")
            for j in range(0, n, 70):                  # wrapped lines
                f.write(s[j:j + 70].lower() if i == 1 else s[j:j + 70])
                f.write("\n")
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(300):
            n = int(rng.integers(30, 151))
            q = "".join(chr(64 + int(x)) for x in rng.integers(2, 41, n))
            f.write(f"@q{i}\n{seq(n)}\n+\n{q}\n")
    return str(fa), str(fq)


@pytest.mark.parametrize("fq_offset", [0, 64])
def test_seqio_batches_match_original(tmp_path, monkeypatch, fq_offset):
    fa, fq = _write_inputs(tmp_path)
    monkeypatch.setattr(jseqio, "FQ_OFFSET", fq_offset)
    for paths in ([fa], [fq], [fa, fq]):
        want = list(jseqio._read_batches_chunked(paths, 64, 256, 1, 31))
        got = list(tseqio.read_batches_chunked(paths, 64, 256, 1, 31,
                                               fq_offset))
        assert len(got) == len(want) >= 1
        for (gc, gq, gcol), (wc, wq, wcol) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            assert (gq is None) == (wq is None) and gcol == wcol
            if gq is not None:
                np.testing.assert_array_equal(gq, wq)
        for max_len in (None, 100):
            want = list(jseqio.read_batches(paths, 50, max_len, 2))
            got = list(tseqio.read_batches(paths, 50, max_len, 2, fq_offset))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])


def test_cli_build_reproduces_golden_ctx(tmp_path):
    from test_goldens import _fixture_seqs
    _genome, reads = _fixture_seqs()
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out = tmp_path / "g.ctx"
    assert port_main(["build", "-k", "11", "--sample", "golden", "--seq",
                      str(fa), str(out), "--device", "cpu"]) == 0
    with open(os.path.join(GOLD, "MANIFEST.json")) as f:
        want = json.load(f)["g.ctx"]
    assert hashlib.sha256(out.read_bytes()).hexdigest() == want


@pytest.mark.parametrize("k", [21, 63])
def test_cli_multicolour_masked_build_matches_mctx(tmp_path, monkeypatch, k):
    # `mctx build -O` sets the reader's module-wide FQ_OFFSET; restore it
    # afterwards so later tests in this process auto-detect again
    monkeypatch.setattr(jseqio, "FQ_OFFSET", jseqio.FQ_OFFSET)
    fa, fq = _write_inputs(tmp_path)
    args = ["build", "-k", str(k), "-Q", "12", "-H", "5", "-O", "64",
            "--sample", "one", "--seq", fq, "--sample", "two", "--seq", fa,
            "--seq", fq]
    a, b = tmp_path / "mctx.ctx", tmp_path / "port.ctx"
    assert mctx_main(args + ["-q", str(a)]) == 0
    assert port_main(args + ["-q", "--device", "cpu", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    h, keys, covg, _ = tctx.read_ctx(str(b))
    assert h.ncols == 2 and covg[:, 1].sum() > 0
    if k == 21:     # at k=63 the masked FASTQ-only colour keeps no window
        assert covg[:, 0].sum() > 0


@pytest.mark.parametrize("flag", [["--ref", "ref.fa"], ["--devices", "2"]])
def test_cli_rejects_flags_not_ported(tmp_path, flag, capsys):
    fa, _ = _write_inputs(tmp_path)
    with pytest.raises(SystemExit) as e:
        port_main(["build", "-k", "21", "--sample", "s", "--seq", fa] + flag
                  + ["--device", "cpu", str(tmp_path / "o.ctx")])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cli_device_cuda_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fa, _ = _write_inputs(tmp_path)
    assert port_main(["build", "-k", "21", "--sample", "s", "--seq", fa,
                      str(tmp_path / "o.ctx")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.ctx").exists()

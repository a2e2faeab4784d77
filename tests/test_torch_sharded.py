"""The port's multi-device runs (mccortex_tpu_torch/parallel/shard.py) on
the CPU against mccortex_tpu: shard_of_key, the per-shard key sets of a
sharded build step, build_sharded over 8 CPU shards and over a 2 x 4
grid, lookup_sharded, and `build`, `contigs`, `thread --no-gap-fill` and
`bubbles` with `--devices 8 --device cpu` against `mctx`'s one-device
output.  Everything is integers: exact equality.
"""

import gzip
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccortex_tpu.cli.main import main as mctx_main
from mccortex_tpu.parallel import shard as jsh
from mccortex_tpu_torch.cli.main import main as port_main
from mccortex_tpu_torch.graph import build as tbuild
from mccortex_tpu_torch.graph import store as tstore
from mccortex_tpu_torch.ops import kmer as tkops
from mccortex_tpu_torch.ops import sorted as tsops
from mccortex_tpu_torch.parallel import shard as tsh

from test_ctx_io import write_fasta
from util import random_dna, seq_to_codes

CPU8 = [torch.device("cpu")] * 8
GRID = [[torch.device("cpu")] * 4] * 2
DATE = "2026-01-02 03:04:05"


def _u64(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


@pytest.mark.parametrize("W", [1, 2])
def test_shard_of_key_matches_jax(W):
    rng = np.random.default_rng(40 + W)
    keys = rng.integers(0, 1 << 63, size=(500, W), dtype=np.uint64)
    keys[::2, 0] |= np.uint64(1 << 63)          # the top bit set
    keys[1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    for n in range(1, 9):
        want = np.asarray(jsh.shard_of_key(jnp.asarray(keys), n))
        got = tsh.shard_of_key(_u64(keys), n).numpy()
        np.testing.assert_array_equal(got, want)


def _batch_of_reference_test():
    """The batch of test_sharded.py::test_sharded_build_matches_reference."""
    seqs = [random_dna(80, seed=900 + i) for i in range(16)]
    return np.stack([seq_to_codes(s) for s in seqs])


def test_shard_key_sets_match_jax_sharded_step():
    k = 11
    bases = _batch_of_reference_test()
    mesh = jsh.make_mesh(8)
    step = jsh.build_step_sharded(mesh, k, ncols=1, colour=0,
                                  bucket_cap=512, out_cap=1024)
    state = jsh.empty_sharded_graph(mesh, k, 1, 1024)
    keys, covg, edges, _n, dropped = step(jnp.asarray(bases), *state)
    assert int(np.asarray(dropped).sum()) == 0
    kh = np.asarray(keys).reshape(8, 1024, 1)
    ch = np.asarray(covg).reshape(8, 1024, 1)
    eh = np.asarray(edges).reshape(8, 1024, 1)
    shards = tsh.build_shards([(bases, 0)], k, 1, CPU8)
    for s, g in enumerate(shards):
        live = ~(kh[s] == np.uint64(0xFFFFFFFFFFFFFFFF)).all(axis=1)
        got = tstore.to_host(g)
        np.testing.assert_array_equal(got[0], kh[s][live])
        np.testing.assert_array_equal(got[1], ch[s][live])
        np.testing.assert_array_equal(got[2], eh[s][live])
        assert (tsh.shard_of_key(g.keys, 8) == s).all()


def _skewed_batch(k, shard, n_shards):
    """Reads of one kmer each, every kmer owned by one shard."""
    rng = np.random.default_rng(77)
    reads = rng.integers(0, 4, size=(400, k), dtype=np.uint8)
    kk, _ = tkops.canonical(tkops.pack_kmers(torch.from_numpy(reads), k), k)
    keep = (tsh.shard_of_key(kk, n_shards) == shard).numpy()
    return np.repeat(reads[keep][:20], 3, axis=0)


def _batches(k):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 4, size=(6, 70), dtype=np.uint8), 0),
            (_skewed_batch(k, 3, 8), 1),
            (rng.integers(0, 4, size=(5, 50), dtype=np.uint8), 1),
            (rng.integers(0, 4, size=(9, 70), dtype=np.uint8), 0)]


@pytest.mark.parametrize("k", [13, 33])
@pytest.mark.parametrize("devices", [CPU8, GRID], ids=["flat8", "grid2x4"])
def test_build_sharded_matches_one_device(k, devices):
    batches = _batches(k)
    want = tstore.to_host(tbuild.build(batches, k, 2, device="cpu"))
    g = tsh.build_sharded(batches, k, 2, devices)
    for a, b in zip(tstore.to_host(g), want):
        np.testing.assert_array_equal(a, b)
    assert g.n == len(want[0]) and (want[1][:, 1] == 3).sum() >= 20


def test_skewed_batch_lands_on_one_shard():
    k = 13
    shards = tsh.build_shards([(_skewed_batch(k, 3, 8), 0)], k, 1, CPU8)
    assert [g.n for g in shards] == [0, 0, 0, 20, 0, 0, 0, 0]
    assert (tstore.to_host(shards[3])[1] == 3).all()


def test_lookup_sharded_matches_one_device():
    k = 13
    batches = _batches(k)
    g = tbuild.build(batches, k, 2, device="cpu")
    shards = tsh.build_shards(batches, k, 2, CPU8)
    rng = np.random.default_rng(5)
    absent = _u64(rng.integers(0, 1 << 26, size=(40, 1), dtype=np.uint64))
    nsent = 3 + (-(g.n + 43)) % 4            # Q a multiple of 4
    q = torch.cat([g.keys[torch.from_numpy(rng.permutation(g.n))], absent,
                   tsops.sentinel((nsent,), 1)])
    q = q[torch.from_numpy(rng.permutation(q.shape[0]))].reshape(-1, 4, 1)
    covg, edges, found = tsh.lookup_sharded(shards, q)
    idx, fnd = tstore.lookup(g, q)
    assert torch.equal(found, fnd) and int(fnd.sum()) == g.n
    il = idx.long()
    assert torch.equal(covg, torch.where(fnd[..., None], g.covg[il], 0))
    assert torch.equal(edges, torch.where(fnd[..., None], g.edges[il], 0
                                          ).to(torch.uint8))


def test_walk_dp_matches_one_device():
    from mccortex_tpu_torch.graph import traverse as T
    k = 11
    seq = random_dna(300, seed=650)
    g = tbuild.build([(seq_to_codes(seq)[None, :], 0)], k, 1, device="cpu")
    seeds = torch.from_numpy((np.arange(19) * 7) % g.n).to(torch.int32)
    ors = torch.from_numpy(np.arange(19) % 2).to(torch.uint8)
    st = T.walk(g, T.walk_init(g, seeds, ors, 32), None, 32)
    vert, n = tsh.walk_dp(g, seeds, ors, None, 32, CPU8)
    assert torch.equal(vert, st.out_vert) and torch.equal(n, st.out_len)


def test_thread_reads_round_robin_matches_one_device():
    """Five read batches on 8 devices (batch i on device i mod 8): the
    one-device link store."""
    from mccortex_tpu_torch.links import store as tlstore
    from mccortex_tpu_torch.links import thread as tthread
    k = 11
    rep = random_dna(30, seed=661)
    genome = (random_dna(100, seed=662) + rep + random_dna(80, seed=663)
              + rep + random_dna(100, seed=664))
    reads = [seq_to_codes(genome[s:s + 60]) for s in range(0, 280, 7)]
    g = tbuild.build([(np.stack(reads), 0)], k, 1, device="cpu")
    batches = [(np.stack(reads[i:i + 9]), 0) for i in range(0, 40, 9)]
    one = tthread.thread_reads(g, batches, 1)
    eight = tthread.thread_reads(g, batches, 1, devices=CPU8)
    assert one.nlinks > 0
    for a, b in zip(tlstore.to_host(one), tlstore.to_host(eight)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the commands with --devices 8, against mctx's one-device output
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A 1.2 kb genome and a copy with 6 SNPs, 60 reads of each (two
    colours, k = 15), and mctx's one-device build, contigs, thread
    --no-gap-fill and bubbles of them."""
    d = tmp_path_factory.mktemp("sharded_cli")
    genome = random_dna(1200, seed=3300)
    alt = list(genome)
    for p in range(100, 1200, 200):
        alt[p] = "ACGT"[("ACGT".index(alt[p]) + 2) % 4]
    alt = "".join(alt)
    rng = np.random.default_rng(3301)
    fa = {}
    for name, g in (("a", genome), ("b", alt)):
        fa[name] = str(d / f"{name}.fa")
        write_fasta(fa[name], [g[s:s + 90] for s in
                               rng.integers(0, len(g) - 90, 60)])
    f = dict(d=d, fa=fa, ctx=str(d / "g.ctx"))
    build = ["build", "-k", "15", "-s", "a", "--seq", fa["a"], "-s", "b",
             "--seq", fa["b"]]
    assert mctx_main(build + [f["ctx"]]) == 0
    f["build"] = build
    f["want"] = {"build": open(f["ctx"], "rb").read()}
    for cmd, argv in _commands(f).items():
        out = str(d / f"{cmd}.out")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "strftime", lambda fmt, *a: DATE)
            assert mctx_main(argv + ["-o", out, f["ctx"]]) == 0
        f["want"][cmd] = _read(out)
    return f


def _commands(f):
    return {"contigs": ["contigs"],
            "thread": ["thread", "--no-gap-fill", "--seq", f["fa"]["a"]],
            "bubbles": ["bubbles"]}


def _read(path):
    """Bytes, or decompressed text with the generator and the recorded
    --devices flag masked."""
    raw = open(path, "rb").read()
    if raw[:2] != b"\x1f\x8b":
        return raw
    text = gzip.decompress(raw).decode()
    text = re.sub(r'"generator": "[^"]*"', '"generator": "-"', text)
    return text.replace(" --devices 8", "")


@pytest.mark.parametrize("cmd", ["build", "contigs", "thread", "bubbles"])
def test_command_devices_8_writes_mctx_bytes(cli, cmd, monkeypatch, capsys):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: DATE)
    out = str(cli["d"] / f"{cmd}.out")
    if cmd == "build":
        argv = cli["build"] + [out]
    else:
        argv = _commands(cli)[cmd] + ["-o", out, cli["ctx"]]
    if os.path.exists(out):            # mctx's, moved aside (no -f: a
        os.replace(out, out + ".mctx")  # .ctp header records the command)
    capsys.readouterr()
    assert port_main(argv + ["--devices", "8", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert re.search(r"over 8 devices", err)
    want = cli["want"][cmd]
    assert _read(out) == want
    if cmd == "bubbles":
        assert want.count(">bubble.") >= 4

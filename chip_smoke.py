#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mccortex_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device, nvcc
and PyTorch built for CUDA.  Phases, each fatal on failure:

1. probe: torch and CUDA versions, the card's name and power limit;
2. build the kernels (csrc/*.cu) with nvcc, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, exact (integer outputs: tolerance 0),
   with CUDA-event times of both, the least time the card could take
   (bound) and, where one PyTorch call computes the same function, that
   call's time.  The front-end runs on a batch of 2048 reads of 150 bp
   at k=31 and k=63, both writing every window and writing an epoch's
   (the first L-k+1 windows of every row, the build's call); segreduce
   at an epoch's shape (those sorted records, the count kept) and at the
   build's merge shape (8,388,608 records, the count dropped, a run of
   100,000 equal keys over many tiles, a sentinel tail), both as one
   tensor of planes and as the reference's tuple; then the device
   operations of one lax build epoch under torch.profiler.  The sort
   kernels (tile sort, tail, butterfly, merge
   level) and the sorts and merges built from them (sort_planes,
   merge_planes, sort_planes_mp) run at an epoch's shape (k=31 and k=63)
   and an LSM merge's (2 x 4M records), to the tie contract of
   ops/kernels/bitonic.py, beside torch.sort.  The merge level runs by
   both of its kernels (a pair's tiles; whole groups staged in shared
   memory), the fused levels against the plain levels and a stable sort
   of every group; the tail at 1, 2 and 4 key planes, over spans of one
   tile and of two, and on equal keys with distinct payloads; the kernel
   launches of one epoch sort under mp and bitonic are counted, and both
   sorts timed at every size of fused group and tail span.  The lookup
   kernel runs at
   W=1 and W=2 against a store of the E. coli graph's size (9.2M keys),
   with present, absent and sentinel queries, at a walker's batch (4096)
   and a bulk batch (Q = N), on the 128-byte-row table the port uses
   and on the reference-shaped 128-lane table (table bytes, rows read
   per query and row bytes/s against the card's 3.35 TB/s for each);
   beside it the plain bucket-row gather (lookup_planar) and the
   sort-merge joins (lookup_join, variants lax and mp) are timed; then
   on tables crowded by a forced small b_bits, where probes chain over
   many rows and past the last row;
4a. ingest: the native sequence reader is built with g++ and zlib (a
   failure is fatal), then the E. coli FASTQ below is read through the
   Python reader and through the native reader without and with
   prefetch, as `build` reads it: the batches must be equal, and each
   reader's seconds are printed;
4. the build path at real size: `mctx-torch build -k 31` (the CLI entry
   point, called in-process so the kernels' launch counts are visible)
   on 20x of 150 bp reads of a synthetic 4.6 Mb E. coli-sized genome,
   under each sort engine (lax, mp, bitonic) through the native reader,
   then once more under lax through the Python reader, each with its
   CLI wall split into read, graph build and write; the lax .ctx is held
   against a numpy count of the reads' kmers and the others against its
   bytes; one lax graph build of the same reads under torch.profiler
   gives the front-end's and segreduce's device time summed over a
   build, its device operations and the device's busy share.  Then the
   same reads as mate pairs with planted duplicate
   pairs, built with -p through --seq2 and through --seqi (equal bytes,
   the removed count and the kmers held against a numpy rendering of
   the rule), and once more with --intersect against the graph of the
   genome's own kmers;
4b. the graph path on that .ctx: `mctx-torch clean -T -U`, then
   `mctx-torch unitigs` of the cleaned graph, each of which must launch
   the lookup kernel; the cleaned graph must be a subset of the raw one
   with its coverage, hold every kmer its edges point at, and be smaller;
   the unitigs' kmers must be the cleaned kmer set, each once.  Prints
   each command's wall time and its split (table build on the host,
   adjacency, pointer doubling, extraction), the cleaning threshold and
   the genome and non-genome kmers kept;
4c. `graph/kmer_occur.build_kograph` of that raw graph against its
   genome, which must launch the lookup kernel; its CSR is held against
   a numpy index of the genome's kmers;
4d. the graph walks on the cleaned graph of 4b: `mctx-torch contigs`
   over the whole graph (the linkless unitig-hop walker, batches of 512
   seeds), `assemble_linkless_contigs` of 256 seeds at max_len 200,000
   (the recipe of scripts/scale_test.py), cold and warm, `inferedges`
   (--pop on the graph, --all on a copy with ~1 % of its edge bits
   cleared) and `subgraph --dist 5` of a 20 kb slice of the genome; each
   command must launch the lookup kernel.  Checked in numpy: every
   contig's kmers are in the graph and the longest contig is a
   substring of the genome or its reverse complement; inferred edges
   only add bits, each joining two kmers covered in its colour, and
   --all restores exactly the bits cleared; the subgraph is a subset of
   the graph holding every slice kmer the graph has.  One batch of the hop walker runs under torch.profiler:
   device operations per hop and the device's busy share;
4e. links on that cleaned graph, through the CLI on the card: `thread
   --no-gap-fill` of all the reads, `thread` (gap filling) of the first
   32,768 (a quarter of the 131,072 of scripts/scale_test.py, to stay in the
   time limit), `check -p` of both
   (0 bad links), `contigs -p -N 512` (one batch of 512 random seeds,
   not the whole graph, to stay in the time limit) with the first's
   links (--batch 512, --max-len 65536, --no-reseed); each must launch
   the lookup kernel.  Checked in numpy: the contigs as in 4d, and 1000
   links of each file walked from their kmer along the graph's edge
   bytes, every junction an existing branch at a fork, all consumed
   before a dead end.  `assemble_contigs_primed` of 256 seeds at max_len
   200,000 with the gap-filled links, cold and warm; one gap-fill batch
   and one `contigs -p` batch under torch.profiler: walker steps, device
   operations a step, the device's busy share;
4f. paired-end links and read correction on that cleaned graph: a
   library of 4,096 fragments of 400-500 bp drawn from the genome with
   numpy (mate 1 the first 150 bp, mate 2 the reverse complement of the
   last 150 bp, 0.3 % substitutions); `thread -2` (gap-filled, -L 600)
   with `check -p` and 1000 of its links walked in numpy; one batch of
   2048 pairs under torch.profiler; `links -T -H -l`, then `links -c`
   at the suggested cutoff (every cleaned link a prefix of an input link
   at its kmer and orientation, no more links than before); `correct`
   of 8,192 single reads and 2,048 pairs with those links (more reads
   equal to their genome substring after than before); `reads` of the
   first 131,072 reads with and without -v (the kept counts those of a numpy
   membership test); `coverage -e -E` of 4096 reads (every coverage the
   graph's, in numpy).  Each command must launch the lookup kernel;
4g. variant calling on phase 4's genome: 500 SNPs and 50 indels of
   1-10 bp planted with numpy (seed 7, at least 300 bp apart; a quarter
   of the depth first planned, to stay in the time limit) in a
   sample whose reads (20x of 150 bp, 0.3 % substitutions) are built and
   cleaned (`clean -T -U`) as colour 0, the genome built as colour 1,
   the two joined (`join`); then `bubbles -H 1`, `calls2vcf`,
   `breakpoints -s` and its `calls2vcf`, `vcfcov -r`, `vcfgeno` and
   `popbubbles` with `check` of the popped graph, each command that
   reads the graph launching the lookup kernel.  Gates: every VCF
   record's REF is the genome at POS; at least 90 % of the planted SNPs
   outside the 15 repeat families called with their POS/REF/ALT; the
   joined graph has a ref-only branch at each of those SNPs; popbubbles
   pops at least one bubble into a graph with fewer kmers that `check`
   passes.  Prints each command's wall and split, forks, walkers and
   walker steps, one bubbles walk under torch.profiler (device
   operations a step, busy share), and recall and false calls split
   into SNPs and indels;
5. byte identity: a 2-colour build of a 200 kb genome at k=31 and k=63
   (k=31 under every sort engine), colour a's reads as SAM, BAM and CRAM
   (each must give the FASTQ build's bytes), a --graph + --seq2 -p
   build, then at k=31 `clean -T -U`, `unitigs` and `unitigs --gfa`,
   each on the card and with the plain versions on the CPU;
5b. the store-only commands on the k=31 graphs, on the card and on the
   CPU, with equal outputs: `join` (two graphs, --flatten, -i), `check`,
   `view -k -i`, `dist`, `sort` of a scrambled copy and `index`; join
   must launch the segreduce kernel, and join -i the lookup kernel;
5c. `contigs -N 64`, `inferedges`, `subgraph -U` and `pjoin -r` (of a
   link file the port's save_ctp wrote) on that 2-colour graph, on the
   card and on the CPU: the same FASTA and .ctx bytes and the same
   decompressed .ctp text (the date fixed); the inferred edges held to
   the numpy rule as in 4d;
5d. on the cleaned 2-colour graph: `thread` (default, --no-gap-fill, -W,
   -p with -0) of 2048 reads of colour a, `contigs -p` (-N 64,
   --max-len 150; -P from
   the links of 64 reads; -C 0.5 -G 200000) and `check -p`, on the card
   and on the CPU: the same decompressed .ctp text (the date fixed, only
   the generator masked), FASTA bytes and status lines;
5e. `thread -2` and `thread -i -W` of 2048 fragments of colour a's
   genome, `links -c -l -T -H -P -L`, `reads -1/-2/-i` and `-v`,
   `coverage -e -E` and `correct -1/-2/-i -F fastq -W -p`, on the card
   and on the CPU: the same bytes and status lines;
5f. on the cleaned 2-colour graph of phase 5 (colour b carries 0.5 %
   SNPs against colour a's genome): `bubbles`, `popbubbles`,
   `calls2vcf` (-O vcf, bcf, vcfgz), `breakpoints` and its `calls2vcf`,
   `vcfcov` and `vcfgeno`, on the card and on the CPU: the same bytes
   (call files decompressed, `generator` masked) and status lines; the
   commands that read the graph launch the lookup kernel on the card;
5g. `mctx-torch pipeline` once on the card, on the 100 kb diploid case
   of tests/test_pipeline_scale.py (its seeded simulation copied): every
   truth variant and the 400 bp deletion in its VCF, GT in the
   genotyped VCF.

Prints a JSON line of per-kernel results (segreduce's launches split into
the epochs' and the merges'), then `{"ok": true, "device":
...}` as its last line.  Exits non-zero, printing no result, when CUDA
is unavailable or the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
K_MAIN = 31
GENOME_BP = 4_600_000     # phase 4's genome, E. coli-sized
MERGE_ITEM = 1 << 22      # records a side of phase 3's LSM merge
ENGINE_KERNELS = {        # what a build must launch under each sort engine
    "lax": ("frontend", "segreduce", "mergepath"),
    "mp": ("frontend", "segreduce", "mergepath", "bitonic_blocksort",
           "mergelevel"),
    "bitonic": ("frontend", "segreduce", "bitonic_blocksort", "bitonic_tail",
                "bitonic_butterfly")}
HBM_BYTES_S = 3.35e12     # H100 SXM device memory, data sheet
ALU_OPS_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
SIGN = -(1 << 63)
CHAR_CODES = np.full(256, 4, np.uint8)
CHAR_CODES[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def elapsed(phase: str):
    print(f"elapsed: {phase} done at {time.perf_counter() - T0:.1f}s")


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps calls (CUDA events).  A sleep
    kernel first holds the stream while the host queues every call, so
    the events time the device work back to back, not the host's
    launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def row(err, ms, plain_ms, nbytes, nops, library_ms=None) -> dict:
    """One kernel's entry.  bound_ms is the larger of its bytes (every
    input read once, every output written once) over the card's memory
    rate and its 32-bit integer operations (an estimate of the compares,
    shifts and adds the function needs on these inputs) over the card's
    rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / ALU_OPS_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_profile(torch, fn):
    """fn() once under torch.profiler (device activity only): its device
    operations by kind (kernel, memset, memcpy), device microseconds by
    operation name, and the host wall seconds.  Empty counts where the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds = {"kernel": 0, "memset": 0, "memcpy": 0}
    us = {}
    # the raw events: prof.events() would first build a Python object for
    # each, tens of seconds for a walk's hundreds of thousands
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        low = name.lower()
        kinds["memset" if "memset" in low else
              "memcpy" if "memcpy" in low else "kernel"] += 1
        us[name] = us.get(name, 0.0) + e.duration_ns() / 1e3
    return kinds, us, wall


def keys64(planes):
    """The two key planes of (np, M) int32 records packed into one int64
    word a record, signed order = the planes' unsigned order."""
    return ((planes[0].long() << 32) | (planes[1].long() & 0xFFFFFFFF)) ^ SIGN


# ---------------------------------------------------------------------------
# synthetic data (numpy, seeded)
# ---------------------------------------------------------------------------

def genome_and_reads(gsize: int, cov: float, seed: int, rlen: int = 150,
                     err: float = 0.003):
    """Random genome with planted repeat families, and reads sampled from
    it with substitutions (the recipe of scripts/scale_test.py)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, gsize, dtype=np.uint8)
    n_fam = max(4, gsize // 300_000)
    for _ in range(n_fam):
        ulen = int(rng.integers(500, 1500))
        unit = rng.integers(0, 4, ulen, dtype=np.uint8)
        for _ in range(24):
            p = int(rng.integers(0, gsize - ulen))
            genome[p:p + ulen] = unit
    reads, starts = reads_of(genome, cov, rng, rlen, err)
    return genome, reads, starts


def reads_of(genome: np.ndarray, cov: float, rng, rlen: int = 150,
             err: float = 0.003):
    """(reads, starts): reads of `cov` x drawn uniformly from the genome,
    with substitutions at rate `err`."""
    gsize = len(genome)
    nreads = int(gsize * cov / rlen)
    starts = rng.integers(0, gsize - rlen, nreads)
    reads = np.lib.stride_tricks.sliding_window_view(
        genome, rlen)[starts].copy()
    nerr = int(err * reads.size)
    ei = rng.integers(0, nreads, nerr)
    ej = rng.integers(0, rlen, nerr)
    reads[ei, ej] = rng.integers(0, 4, nerr, dtype=np.uint8)
    return reads, starts


def repeat_mask(gsize: int, seed: int) -> np.ndarray:
    """True over the copies of the repeat families genome_and_reads plants
    (the same draws of its generator, in the same order)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, gsize, dtype=np.uint8)
    mask = np.zeros(gsize, bool)
    for _ in range(max(4, gsize // 300_000)):
        ulen = int(rng.integers(500, 1500))
        rng.integers(0, 4, ulen, dtype=np.uint8)
        for _ in range(24):
            p = int(rng.integers(0, gsize - ulen))
            mask[p:p + ulen] = True
    return mask


def write_fastq(path: str, reads: np.ndarray, quals: np.ndarray | None = None):
    seqs = np.frombuffer(b"ACGTN", np.uint8)[reads]
    if quals is None:
        quals = np.full(reads.shape, 40, np.uint8)
    qchars = (quals + 33).astype(np.uint8)
    with open(path, "wb") as fh:
        for i in range(reads.shape[0]):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
                                              qchars[i].tobytes()))


def write_sam(path: str, reads: np.ndarray, quals: np.ndarray):
    """Unmapped SAM records of the reads, with a header line."""
    seqs = np.frombuffer(b"ACGTN", np.uint8)[reads]
    qchars = (quals + 33).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"@HD\tVN:1.6\tSO:unsorted\n")
        for i in range(reads.shape[0]):
            fh.write(b"r%d\t4\t*\t0\t0\t*\t*\t0\t0\t%s\t%s\n"
                     % (i, seqs[i].tobytes(), qchars[i].tobytes()))


def write_bam(path: str, reads: np.ndarray, quals: np.ndarray):
    """Unmapped BAM records of the reads (one gzip member: BGZF readers
    take it), 4-bit bases, phred qualities."""
    import gzip
    import struct
    nib = np.array([1, 2, 4, 8, 15], np.uint8)[reads]      # =ACMGRSVTWYHKDBN
    L = reads.shape[1]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((len(nib), 1), np.uint8)], 1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    out = [b"BAM\x01", struct.pack("<i", 0), struct.pack("<i", 0)]
    for i in range(reads.shape[0]):
        qn = b"r%d\x00" % i
        body = struct.pack("<iiBBHHHiiii", -1, -1, len(qn), 0, 4680, 0, 4, L,
                           -1, -1, 0)
        body += qn + packed[i].tobytes() + quals[i].tobytes()
        out.append(struct.pack("<i", len(body)) + body)
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(out))


def write_cram(path: str, reads: np.ndarray, quals: np.ndarray):
    """Unmapped CRAM 3.0 records of the reads (rANS blocks), written by
    the port's own CRAM writer."""
    from mccortex_tpu_torch.io import cram
    seqs = np.frombuffer(b"ACGTN", np.uint8)[reads]
    cram.write_cram(path, [(f"r{i}", seqs[i].tobytes().decode(), quals[i])
                           for i in range(reads.shape[0])])


def kmers_np(seqs: np.ndarray, k: int):
    """(forward, reverse complement) k <= 31 kmers (uint64) of every
    window of every row of an N-free (n, L) code array, row-major."""
    n, L = seqs.shape
    nw = L - k + 1

    def forward(s):
        # words of 1, 2, 4, ... bases at every start, each from two of
        # half the width; a window of k bases joins the words of k's bits
        words, w = {1: s}, 1
        while 2 * w <= k:
            a = words[w]
            words[2 * w] = (a[:, :-w] << np.uint64(2 * w)) | a[:, w:]
            w *= 2
        out, off = None, 0
        for w in sorted(words, reverse=True):
            if k & w:
                part = words[w][:, off:off + nw]
                out = part if out is None else \
                    (out << np.uint64(2 * w)) | part
                off += w
        return out

    # the reverse complement's windows are the forward windows of the
    # complemented row read backwards, in reverse order; rows go in
    # blocks of about 64K bases so that the words stay in cache
    fw = np.empty((n, nw), np.uint64)
    rc = np.empty((n, nw), np.uint64)
    step = max(1, (1 << 16) // L)
    for s in range(0, n, step):
        c = seqs[s:s + step]
        fw[s:s + step] = forward(c.astype(np.uint64))
        rc[s:s + step] = forward((3 - c[:, ::-1]).astype(np.uint64))[:, ::-1]
    return fw.reshape(-1), rc.reshape(-1)


def canonical_kmers_np(seqs: np.ndarray, k: int) -> np.ndarray:
    """Canonical k <= 31 kmers (uint64) of every window of every row of
    an N-free (n, L) code array, row-major."""
    return np.minimum(*kmers_np(seqs, k))


def valid_windows_np(reads: np.ndarray, k: int) -> int:
    bad = np.concatenate([np.zeros((reads.shape[0], 1), np.int64),
                          np.cumsum(reads >= 4, axis=1)], axis=1)
    L = reads.shape[1]
    return int((bad[:, k:] - bad[:, :L - k + 1] == 0).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, results):
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import frontend, mergepath, segreduce

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    # front-end: one batch of 2048 reads of 150 bp (some shorter, some N)
    B, L = 2048, 150
    bases_np = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases_np[rng.random((B, L)) < 0.005] = 4
    lens = rng.integers(20, L + 1, size=B)
    lens[: B // 2] = L
    bases_np[np.arange(L)[None, :] >= lens[:, None]] = 4
    bases = torch.from_numpy(bases_np).to(dev)
    for k in (K_MAIN, 63):
        got = torch.stack(frontend.records_fused(bases, k))
        want = torch.stack(frontend.records_plain(bases, k))
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            fail(f"frontend k={k}: kernel != plain (max abs err {err})")
        # the epoch's layout: the first L-k+1 windows of every row
        ep = frontend.records_epoch(bases, k)
        err = max(err, max_abs_err(torch, ep,
                                   frontend.records_epoch_plain(bases, k)))
        if err:
            fail(f"frontend k={k}: records_epoch != plain (max abs err {err})")
        ms_all = time_ms(torch, lambda: frontend.records_fused(bases, k))
        ms = time_ms(torch, lambda: frontend.records_epoch(bases, k))
        plain = time_ms(torch,
                        lambda: frontend.records_epoch_plain(bases, k), 5)
        print(f"frontend k={k} B={B} L={L}: exact (every window and the "
              f"epoch's {ep.shape[1]}); records_epoch kernel {ms:.4f} ms, "
              f"every window {ms_all:.4f} ms, plain {plain:.4f} ms")
        if k == K_MAIN:
            # bytes: the bases in, the epoch's planes out; per window the
            # cut of two fields, the mask test, the compare and the stores
            results["frontend"] = row(
                err, ms, plain, nbytes_of(bases, ep),
                ep.shape[1] * (24 + 4 * ep.shape[0]))
            results["frontend"]["all_windows_ms"] = ms_all

    # segreduce, epoch shape: the sorted k=31 records of that batch
    epoch31 = frontend.records_epoch(bases, K_MAIN)
    planes = epoch31[:, sops.argsort_planes(epoch31[:2])].contiguous()
    keys, ors = planes[:2], planes[2:]

    def check_segreduce(label, keys, sums, ors, count=True):
        got, n = segreduce.segreduce_planes(keys, sums, ors, count)
        want, wn = segreduce.segreduce_planes_plain(keys, sums, ors, count)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want) + abs(int(n) - int(wn))
        tup = segreduce.segreduce_compact_multi(keys, sums, ors)
        torch.cuda.synchronize()
        for g, w in zip(tup, segreduce.segreduce_plain(keys, sums, ors)):
            err = max(err, max_abs_err(torch, g.reshape(-1), w.reshape(-1)))
        if err:
            fail(f"segreduce {label}: kernel != plain (max abs err {err})")
        ms = time_ms(torch, lambda: segreduce.segreduce_planes(keys, sums, ors,
                                                               count))
        plain = time_ms(torch, lambda: segreduce.segreduce_planes_plain(
            keys, sums, ors, count), 5)
        print(f"segreduce {label}: n={int(n)} exact (the planes with the "
              f"count {'kept' if count else 'dropped'}, and the reference's "
              f"tuple); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        # per record: the key compare, the sums and ORs, the scans
        return row(err, ms, plain, nbytes_of(keys, sums, ors, got),
                   keys.shape[1] * (keys.shape[0] + sums.shape[0]
                                    + ors.shape[0] + 4))

    empty = torch.empty((0, keys.shape[1]), dtype=torch.int32, device=dev)
    results["segreduce"] = check_segreduce(
        f"epoch M={keys.shape[1]} NS=0 NO=1", keys, empty, ors)

    # segreduce, the build's merge shape (W=1, C=1, count dropped):
    # duplicates, one run of 100000 records over many tiles, a sentinel
    # tail
    M = 2 * MERGE_ITEM
    pool = np.unique(rng.integers(0, 1 << 62, size=M // 2, dtype=np.uint64))
    kv = np.sort(np.concatenate([
        pool[rng.integers(0, len(pool), M - 100_000 - M // 10)],
        np.full(100_000, pool[len(pool) // 2], np.uint64)]))
    kv = np.concatenate([kv, np.full(M // 10, np.uint64(2**64 - 1))])
    kp = np.stack([(kv >> np.uint64(32)).astype(np.uint32),
                   kv.astype(np.uint32)]).view(np.int32)
    keys = torch.from_numpy(kp).to(dev)
    sums = torch.from_numpy(rng.integers(1, 1000, (1, M)).astype(np.int32)
                            ).to(dev)
    ors = torch.from_numpy(rng.integers(0, 256, (1, M)).astype(np.int32)
                           ).to(dev)
    merge = check_segreduce(f"merge M={M} NS=1 NO=1", keys, sums, ors,
                            count=False)
    results["segreduce"].update(merge_ms=merge["ms"],
                                merge_plain_ms=merge["plain_ms"],
                                merge_bound_ms=merge["bound_ms"])
    del keys, sums, ors, kv, kp, pool

    # device operations of one build epoch of that batch under lax
    from mccortex_tpu_torch.graph import build as gbuild
    gbuild._epoch(bases, K_MAIN, "lax")
    kinds, _us, _w = device_profile(
        torch, lambda: gbuild._epoch(bases, K_MAIN, "lax"))
    print(f"device operations of one lax epoch (torch.profiler): "
          f"{json.dumps(kinds) if sum(kinds.values()) else 'not measured'}")

    # merge path: two 4M-record sorted items (2 key planes, covg, edges),
    # unique within each, shared keys across, sentinel tails
    Mh = MERGE_ITEM

    def item():
        live = Mh - Mh // 8
        kv = np.unique(rng.integers(0, 1 << 40, size=live + live // 4,
                                    dtype=np.uint64))[:live]
        kv = np.concatenate([kv, np.full(Mh - len(kv), np.uint64(2**64 - 1))])
        p = np.stack([(kv >> np.uint64(32)).astype(np.uint32),
                      kv.astype(np.uint32),
                      rng.integers(1, 100, Mh).astype(np.uint32),
                      rng.integers(0, 256, Mh).astype(np.uint32)])
        return torch.from_numpy(p.view(np.int32)).to(dev)

    a, b = item(), item()
    got = mergepath.merge_path_planes(a, b, num_keys=2)
    want = mergepath.merge_plain(a, b, 2)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        fail(f"mergepath: kernel != plain (max abs err {err})")
    ms = time_ms(torch, lambda: mergepath.merge_path_planes(a, b, 2))
    plain = time_ms(torch, lambda: mergepath.merge_plain(a, b, 2), 5)
    print(f"mergepath Ma=Mb={Mh} np=4: exact (every plane, element for "
          f"element); kernel {ms:.4f} ms, plain {plain:.4f} ms")
    ab64 = torch.cat([keys64(a), keys64(b)])
    lib = time_ms(torch, lambda: torch.sort(ab64, stable=True), 5)
    print(f"mergepath: torch.sort of the {2 * Mh} concatenated 64-bit keys "
          f"(the merged order, no gather) {lib:.4f} ms")
    results["mergepath"] = row(err, ms, plain, nbytes_of(a, b, got),
                               2 * Mh * MERGE_OPS(2), lib)
    del ab64
    return dict(epoch31=epoch31.contiguous(), bases=bases, a=a, b=b)


def MERGE_OPS(nk: int) -> int:
    """Operations per merged record: its share of the diagonal searches
    and one key compare of nk words on each side."""
    return 2 * nk + 6


def phase_sorts(torch, results, shapes):
    """The sort kernels and the sorts and merges built from them, against
    their plain versions, to the tie contract: tile sort, merge level and
    sort_planes_mp equal a stable sort on every plane; tail, butterfly,
    sort_planes and merge_planes equal their plain versions (the same
    network) on every plane, and a stable sort on the key planes."""
    from mccortex_tpu_torch.graph import build as gbuild
    from mccortex_tpu_torch.ops import kmer as kops
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import _build, bitonic, mergepath

    T = bitonic.TILE
    logT = T.bit_length() - 1
    sorts = []

    def exact(label, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            fail(f"{label}: kernel != plain (max abs err {err})")
        return err

    def stable(x, nk):
        return x[:, sops.argsort_planes(x[:nk])]

    def cmp_ops(nk):           # one compare-exchange: nk words a side
        return 2 * nk + 4

    keys63, ebyte, _v = gbuild.reads_to_records(shapes["bases"], 63)
    Lv = shapes["bases"].shape[1] - 63 + 1
    epoch63 = torch.cat([
        kops.to_planes(keys63[:, :Lv].reshape(-1, 2)),
        ebyte[:, :Lv].reshape(1, -1).to(torch.int32)]).contiguous()
    for label, x, nk in (("epoch k=31", shapes["epoch31"], 2),
                         ("epoch k=63", epoch63, 4)):
        np_, M = x.shape
        if M % (2 * T):
            fail(f"{label}: M = {M} is not a multiple of two tiles")
        tag = f"{label} M={M} np={np_} nk={nk}"
        lib_ok = nk == 2
        k64 = keys64(x) if lib_ok else None

        # tile sort, both direction rules
        want = bitonic.block_sort_plain(x, nk, True, T)
        err = exact(f"blocksort {tag}", bitonic.block_sort(x, nk, True), want)
        alt = bitonic.block_sort(x, nk, False)
        exact(f"blocksort alternating {tag}", alt,
              bitonic.block_sort_plain(x, nk, False, T))
        runs = want
        ms = time_ms(torch, lambda: bitonic.block_sort(x, nk, True))
        plain = time_ms(torch,
                        lambda: bitonic.block_sort_plain(x, nk, True, T), 5)
        lib = time_ms(torch, lambda: torch.sort(k64.view(-1, T), dim=1,
                                                stable=True), 5) \
            if lib_ok else None
        print(f"blocksort {tag}: exact (stable per tile); kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, torch.sort of the tiles' 64-bit "
              f"keys {lib if lib is None else round(lib, 4)} ms")
        if lib_ok:
            results["bitonic_blocksort"] = row(
                err, ms, plain, 2 * nbytes_of(x),
                M // 2 * (logT * (logT + 1) // 2) * cmp_ops(nk + 1), lib)

        # tail and butterfly of the first merge stage, on the alternating
        # tiles
        bf = bitonic.butterfly(alt.clone(), nk, T, 2 * T, False)
        err_b = exact(f"butterfly {tag}", bf,
                      bitonic.cmpx_plain(alt, nk, T, 2 * T, False))
        err_t = exact(f"tail {tag}", bitonic.tail(bf, nk, 2 * T, False),
                      bitonic.tail_plain(bf, nk, 2 * T, False, T))
        check_tails(torch, bitonic, exact, tag, alt, bf, nk)
        # in place: timed on a fresh copy each call, less the copy's time
        ms_b = time_ms(torch, lambda: bitonic.butterfly(alt.clone(), nk, T,
                                                        2 * T, False)) \
            - time_ms(torch, alt.clone)
        plain_b = time_ms(torch, lambda: bitonic.cmpx_plain(alt, nk, T, 2 * T,
                                                            False), 5)
        ms_t = time_ms(torch, lambda: bitonic.tail(bf, nk, 2 * T, False))
        ms_t2 = time_ms(torch, lambda: bitonic.tail(alt, nk, 2 * T, False,
                                                    tile=2 * T))
        plain_t = time_ms(torch, lambda: bitonic.tail_plain(bf, nk, 2 * T,
                                                            False, T), 5)
        # library: one torch.sort over the same spans' 64-bit keys, order
        # only (the stage alternates direction from one 2-tile block to
        # the next, torch.sort sorts every span ascending): the tail's
        # spans of a tile, and the butterfly's pairs j apart as the
        # (M/2j, 2, j) view sorted along its pair axis
        lib_t = lib_b = None
        if lib_ok:
            kt, kb = keys64(bf).view(-1, T), keys64(alt).view(-1, 2, T)
            lib_t = time_ms(torch, lambda: torch.sort(kt, dim=1), 5)
            lib_b = time_ms(torch, lambda: torch.sort(kb, dim=1), 5)
        print(f"butterfly {tag} j={T}: exact; kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms, torch.sort of the (M/2j, 2, j) keys "
              f"{lib_b if lib_b is None else round(lib_b, 4)} ms")
        print(f"tail {tag} k={2 * T}: exact; kernel {ms_t:.4f} ms, plain "
              f"{plain_t:.4f} ms; over spans of two tiles (the butterfly of "
              f"distance {T} with it) {ms_t2:.4f} ms; torch.sort of the "
              f"spans' keys {lib_t if lib_t is None else round(lib_t, 4)} ms")
        if lib_ok:
            results["bitonic_butterfly"] = row(
                err_b, ms_b, plain_b, 2 * nbytes_of(x), M // 2 * cmp_ops(nk),
                lib_b)
            results["bitonic_tail"] = row(
                err_t, ms_t, plain_t, 2 * nbytes_of(x),
                M // 2 * logT * cmp_ops(nk), lib_t)

        # one merge level over the sorted tiles, by the kernel the port
        # takes for it and by the other one
        err = exact(f"mergelevel {tag} R={T}", mergepath.merge_level(runs, nk, T),
                    mergepath.merge_level_plain(runs, nk, T))
        ms = time_ms(torch, lambda: mergepath.merge_level(runs, nk, T))
        with fuse_records(mergepath, 0):
            exact(f"mergelevel by tiles {tag} R={T}",
                  mergepath.merge_level(runs, nk, T),
                  mergepath.merge_level_plain(runs, nk, T))
            ms_tiles = time_ms(torch,
                               lambda: mergepath.merge_level(runs, nk, T))
        plain = time_ms(torch,
                        lambda: mergepath.merge_level_plain(runs, nk, T), 5)
        r64 = keys64(runs) if lib_ok else None
        lib = time_ms(torch, lambda: torch.sort(r64.view(-1, 2 * T), dim=1,
                                                stable=True), 5) \
            if lib_ok else None
        staged = mergepath.fused_levels(np_, T, 1) == 1
        print(f"mergelevel {tag} R={T}: exact (stable); kernel {ms:.4f} ms "
              f"({'whole pairs staged' if staged else 'a pair in tiles'}), "
              f"by a pair's tiles {ms_tiles:.4f} ms, plain {plain:.4f} ms, "
              f"torch.sort of the pairs' 64-bit keys "
              f"{lib if lib is None else round(lib, 4)} ms")
        if lib_ok:
            results["mergelevel"] = row(err, ms, plain, 2 * nbytes_of(x),
                                        M * MERGE_OPS(nk), lib)

        # the levels that fuse, against the plain levels and a stable sort
        # of every group
        levels = mergepath._tree_levels(M, T)
        L = mergepath.fused_levels(np_, T, levels)
        print(f"fused levels at np={np_}: {L} of the tree's {levels} in one "
              f"launch (groups of {T << L} records, "
              f"{mergepath._fused_bytes(np_, T << L)} bytes of shared memory "
              f"a block)")
        if L < 2:
            fail(f"fused levels at np={np_}: fewer than 2 levels fuse")
        _build.LAUNCHES.clear()
        got = mergepath.merge_levels(runs, nk, T, L)
        if _build.LAUNCHES["mergelevel"] != 1:
            fail(f"fused levels {tag}: {L} levels took "
                 f"{_build.LAUNCHES['mergelevel']} launches")
        exact(f"fused levels {tag}", got,
              mergepath.merge_levels_plain(runs, nk, T, L))
        gid = (torch.arange(M, device=x.device) // (T << L)).to(torch.int32)
        exact(f"fused levels {tag} against a stable sort of every group", got,
              x[:, sops.argsort_planes(torch.cat([gid[None], x[:nk]]))])
        ms_f = time_ms(torch, lambda: mergepath.merge_levels(runs, nk, T, L))
        print(f"fused levels {tag}: {L} levels exact (plain levels, stable "
              f"sort of every group) in one launch {ms_f:.4f} ms")

        # the whole sorts
        want = stable(x, nk)
        exact(f"sort_planes_mp {tag}", mergepath.sort_planes_mp(x, nk), want)
        exact(f"sort_planes_mp_plain {tag}",
              mergepath.sort_planes_mp_plain(x, nk), want)
        Mp = bitonic.padded_length(M)
        xp = bitonic.pad_planes(x, nk, Mp)
        got_bt = bitonic.sort_planes(xp, nk)
        exact(f"sort_planes {tag}", got_bt, bitonic.sort_planes_plain(xp, nk))
        check_up_to_ties(torch, sops, f"sort_planes {tag}", got_bt[:, :M],
                         want, nk)
        ms_mp = time_ms(torch, lambda: mergepath.sort_planes_mp(x, nk), 10)
        ms_bt = time_ms(torch, lambda: gbuild._sort_planes32(x, nk, "bitonic"),
                        10)
        ms_lax = time_ms(torch, lambda: gbuild._sort_planes32(x, nk, "lax"),
                         10)
        lib = time_ms(torch, lambda: torch.sort(k64, stable=True), 10) \
            if lib_ok else None
        bound = 2 * nbytes_of(x) / HBM_BYTES_S * 1e3
        print(f"sort {tag}: sort_planes_mp exact (stable, every plane) "
              f"{ms_mp:.4f} ms; bitonic sort_planes (padded to {Mp}) exact to "
              f"the tie contract {ms_bt:.4f} ms; the lax engine (torch.sort "
              f"+ gather) {ms_lax:.4f} ms; torch.sort of the 64-bit keys "
              f"alone {lib if lib is None else round(lib, 4)} ms; one read "
              f"and one write of the records {bound:.4f} ms")
        # kernels launched by one epoch sort (every wrapper call launches
        # one kernel), beside the design before: two kernels a level, a
        # tail of one tile
        stages = (Mp // T).bit_length() - 1
        was = {"mp": 1 + 2 * levels,
               "bitonic": 1 + stages + stages * (stages + 1) // 2}
        wide = bitonic.tail_span(nk) > T     # one butterfly less a stage
        if wide != (nk <= 2):
            fail(f"sort {tag}: the tail spans {bitonic.tail_span(nk)}")
        now = {}
        for engine in ("mp", "bitonic"):
            _build.LAUNCHES.clear()
            gbuild._sort_planes32(x, nk, engine)
            now[engine] = sum(_build.LAUNCHES.values())
        trips = 1 + levels - L + 1
        if now["mp"] != trips or trips >= 1 + levels:
            fail(f"sort {tag}: sort_planes_mp launched {now['mp']} kernels, "
                 f"not the tile sort, one fused launch and {levels - L} "
                 f"levels")
        if now["bitonic"] != was["bitonic"] - (stages if wide else 0):
            fail(f"sort {tag}: bitonic sort_planes launched "
                 f"{now['bitonic']} kernels")
        print(f"kernel launches per epoch sort {tag}: mp {was['mp']} before "
              f"-> {now['mp']} now (tile sort, {L} levels fused, "
              f"{levels - L} levels); bitonic {was['bitonic']} before -> "
              f"{now['bitonic']} now (tile sort, {stages} tails of "
              f"{bitonic.tail_span(nk)} records, the butterflies)")
        by_group, by_span = {}, {}
        for cap in (0, 2 * T, 4 * T, 8 * T):
            with fuse_records(mergepath, cap):
                exact(f"sort_planes_mp {tag} with groups of up to {cap}",
                      mergepath.sort_planes_mp(x, nk), want)
                by_group[cap] = time_ms(
                    torch, lambda: mergepath.sort_planes_mp(x, nk), 10)
        for span in (T, 2 * T):
            saved = bitonic.TAIL_WIDE_KEYS
            bitonic.TAIL_WIDE_KEYS = 4 if span > T else 0
            try:
                exact(f"sort_planes {tag} with tails of {span}",
                      bitonic.sort_planes(xp, nk), got_bt)
                by_span[span] = time_ms(
                    torch, lambda: bitonic.sort_planes(xp, nk), 10)
            finally:
                bitonic.TAIL_WIDE_KEYS = saved
        print(f"sort {tag}: sort_planes_mp by the most records of a fused "
              f"group (0 = every level by a pair's tiles) "
              f"{json.dumps({k: round(v, 4) for k, v in by_group.items()})} "
              f"ms; bitonic sort_planes by the tail's span "
              f"{json.dumps({k: round(v, 4) for k, v in by_span.items()})} ms")
        sorts.append(dict(shape=tag, sort_planes_mp_ms=ms_mp,
                          bitonic_sort_planes_ms=ms_bt, lax_engine_ms=ms_lax,
                          torch_sort_keys_ms=lib, bound_ms=bound,
                          mergelevel_by_tiles_ms=ms_tiles,
                          fused_levels=L, fused_levels_ms=ms_f,
                          tail_two_tiles_ms=ms_t2,
                          launches_mp=[was["mp"], now["mp"]],
                          launches_bitonic=[was["bitonic"], now["bitonic"]],
                          sort_planes_mp_by_group_ms=by_group,
                          bitonic_sort_planes_by_span_ms=by_span))

    # an LSM merge: two sorted items of 4M records
    a, b = shapes["a"], shapes["b"]
    Mh = a.shape[1]
    both = torch.cat([a, b], dim=1)
    want = mergepath.merge_plain(a, b, 2)
    exact("mergelevel LSM merge", mergepath.merge_level(both, 2, Mh), want)
    exact("mergelevel LSM merge against its plain version",
          mergepath.merge_level_plain(both, 2, Mh), want)
    got = bitonic.merge_planes(a, b, 2)
    exact("merge_planes LSM merge", got, bitonic.merge_planes_plain(a, b, 2))
    check_up_to_ties(torch, sops, "merge_planes LSM merge", got, want, 2)
    ms_ml = time_ms(torch, lambda: mergepath.merge_level(both, 2, Mh), 10)
    ms_mp = time_ms(torch, lambda: mergepath.merge_path_planes(a, b, 2), 10)
    ms_bt = time_ms(torch, lambda: bitonic.merge_planes(a, b, 2), 5)
    bitonic_in = torch.cat([a, b.flip(1)], dim=1)
    ms_t = time_ms(torch, lambda: bitonic.tail(bitonic_in, 2, 2 * Mh, True),
                   10)
    ms_b = time_ms(torch, lambda: bitonic.butterfly(bitonic_in.clone(), 2, Mh,
                                                    2 * Mh, True), 10) \
        - time_ms(torch, bitonic_in.clone, 10)
    bound = 2 * nbytes_of(both) / HBM_BYTES_S * 1e3
    print(f"LSM merge Ma=Mb={Mh} np=4 nk=2: merge_level (one pair) exact "
          f"{ms_ml:.4f} ms; merge_path_planes {ms_mp:.4f} ms; bitonic "
          f"merge_planes exact to the tie contract {ms_bt:.4f} ms (of it "
          f"one tail {ms_t:.4f} ms, one butterfly {ms_b:.4f} ms); one read "
          f"and one write {bound:.4f} ms")
    sorts.append(dict(shape=f"LSM merge Ma=Mb={Mh} np=4 nk=2",
                      merge_level_ms=ms_ml, merge_path_planes_ms=ms_mp,
                      bitonic_merge_planes_ms=ms_bt, tail_ms=ms_t,
                      butterfly_ms=ms_b, bound_ms=bound))
    return sorts


@contextlib.contextmanager
def fuse_records(mergepath, cap: int):
    """The merge levels with groups of at most cap records fused (0: every
    level by the kernel that merges a pair's tiles)."""
    saved, mergepath.FUSE_RECORDS = mergepath.FUSE_RECORDS, cap
    try:
        yield
    finally:
        mergepath.FUSE_RECORDS = saved


def check_tails(torch, bitonic, exact, tag, alt, bf, nk):
    """The tail against tail_plain beyond the timed call: over spans of two
    tiles, descending spans, the last stage, one key plane, and a tile of
    equal keys with distinct payloads (no record may move)."""
    T = bitonic.TILE
    M = alt.shape[1]
    for span, src in ((T, bf), (2 * T, alt)):
        for k, final_asc in ((2 * T, False), (2 * T, True), (8 * T, False)):
            exact(f"tail {tag} span={span} k={k} final_asc={final_asc}",
                  bitonic.tail(src, nk, k, final_asc, tile=span),
                  bitonic.tail_plain(src, nk, k, final_asc, span))
        one = src[[0, src.shape[0] - 1]].contiguous()   # 1 key plane
        exact(f"tail {tag} span={span} nk=1",
              bitonic.tail(one, 1, 2 * T, False, tile=span),
              bitonic.tail_plain(one, 1, 2 * T, False, span))
        same = src.clone()
        same[:nk] = 12345
        same[nk] = torch.arange(M, device=src.device, dtype=torch.int32)
        got = bitonic.tail(same, nk, 2 * T, False, tile=span)
        exact(f"tail {tag} span={span} on equal keys", got,
              bitonic.tail_plain(same, nk, 2 * T, False, span))
        if not torch.equal(got, same):
            fail(f"tail {tag} span={span}: equal keys moved a record")
    print(f"tail {tag}: exact against tail_plain at nk={nk} and nk=1, spans "
          f"of {T} and {2 * T}, ascending, descending and last stages, and "
          f"on equal keys (no record moves)")


def check_up_to_ties(torch, sops, label, got, want, nk):
    """Key planes equal element for element; whole records the same
    multiset within every run of equal keys (both sorted on all planes)."""
    if not torch.equal(got[:nk], want[:nk]):
        fail(f"{label}: key planes differ from the stable sort's")
    if not torch.equal(got[:, sops.argsort_planes(got)],
                       want[:, sops.argsort_planes(want)]):
        fail(f"{label}: records differ from the stable sort's as a multiset")


N_STORE = 9_165_696      # distinct kmers of the phase-4 E. coli build
# (W, keys, b_bits) of the crowded lookup tables: fill 0.95, 0.95, 0.90
CROWDED = ((1, 1_245_000, 17), (2, 747_000, 17), (4, 354_000, 17))


def lookup_store(rng, n: int, W: int) -> np.ndarray:
    """n sorted, unique, valid (word 0 < 2**62) random keys (n, W)."""
    if W == 1:
        kv = np.unique(rng.integers(0, 1 << 62, size=n + n // 50,
                                    dtype=np.uint64))
        return np.sort(rng.choice(kv, n, replace=False))[:, None]
    w = np.stack([rng.integers(0, 1 << 62, size=n, dtype=np.uint64),
                  rng.integers(0, 2**64, size=n, dtype=np.uint64)], axis=1)
    return w[np.lexsort(w.T[::-1])]


def lookup_queries(rng, keys: np.ndarray, Q: int) -> np.ndarray:
    """60 % present, 35 % absent (random words), 5 % sentinel."""
    W = keys.shape[1]
    q = keys[rng.integers(0, len(keys), Q)]
    r = rng.random(Q)
    absent = r >= 0.6
    q[absent] = rng.integers(0, 1 << 62, size=(int(absent.sum()), W),
                             dtype=np.uint64)
    q[r >= 0.95] = np.uint64(2**64 - 1)
    return q


def rows_named(torch, kops, q, rows, b_bits) -> int:
    """Distinct table rows that the probes of queries q read: the home
    row of every live query and the rows its chain walks on to."""
    live = rows > 0
    home = kops.srl(kops.kmer_hash(q[live]), 64 - b_bits)
    n = rows[live]
    seen = [home]
    for d in range(1, int(n.max()) if n.numel() else 0):
        seen.append((home[n > d] + d) & ((1 << b_bits) - 1))
    return int(torch.unique(torch.cat(seen)).numel())


def check_lookup(torch, label, lookup, table, b_bits, q, W):
    """The kernel against its plain version on one table, exact."""
    idx, found = lookup.lookup_fused(table, q, b_bits, W)
    want = lookup.lookup_plain(table, q, b_bits, W)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, idx, want[0]),
              max_abs_err(torch, found, want[1]))
    if err:
        fail(f"lookup {label}: kernel != plain (max abs err {err})")
    return idx, found, err


def phase_lookup(torch, results):
    from mccortex_tpu_torch.ops import hashidx
    from mccortex_tpu_torch.ops import kmer as kops
    from mccortex_tpu_torch.ops import sorted as sops
    from mccortex_tpu_torch.ops.kernels import lookup

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)

    def on_card(a, view):
        return torch.from_numpy(a.view(view)).to(dev)

    for W in (1, 2):
        keys_np = lookup_store(rng, N_STORE, W)
        t0 = time.perf_counter()
        t32, b32 = lookup.build_table32(keys_np)
        host32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        t128, b128 = lookup.build_table128(keys_np)
        host128 = time.perf_counter() - t0
        tplan, bplan = hashidx.build_table(keys_np)
        keys = on_card(keys_np, np.int64)
        # the table the port uses first, the reference-shaped one second
        tables = {32: (on_card(t32, np.int32), b32),
                  128: (on_card(t128, np.int32), b128)}
        tplan = on_card(tplan, np.int32)
        print(f"lookup W={W}: store of {N_STORE} keys; 128-byte-row table "
              f"2^{b32} rows = {t32.nbytes} bytes, fill "
              f"{N_STORE / (lookup.slots_for(W, 32) << b32):.3f} (host build "
              f"{host32:.1f}s); 128-lane table 2^{b128} rows = {t128.nbytes} "
              f"bytes (host build {host128:.1f}s); planar table 2^{bplan} "
              f"rows")
        if t32.nbytes > t128.nbytes:
            fail(f"lookup W={W}: the 128-byte-row table is the larger one")
        del t32, t128
        for Q in (4096, N_STORE):
            q = on_card(lookup_queries(rng, keys_np, Q), np.int64)
            reps = 20 if Q < N_STORE else 10
            timed = {}
            for R, (table, bb) in tables.items():
                got = check_lookup(torch, f"W={W} Q={Q} row of {R}", lookup,
                                   table, bb, q, W)
                if R == 32:
                    idx, found, err = got
                elif not (torch.equal(got[0], idx) and
                          torch.equal(got[1], found)):
                    fail(f"lookup W={W} Q={Q}: the two tables disagree")
                ms = time_ms(torch, lambda: lookup.lookup_fused(table, q, bb,
                                                                W), reps)
                plain = time_ms(
                    torch, lambda: lookup.lookup_plain(table, q, bb, W), 5)
                rows = lookup.rows_read(table, q, bb, W)
                nrows = int(rows.sum())
                rate = nrows * R * 4 / (ms * 1e-3)
                timed[R] = (ms, plain, rows, bb)
                print(f"lookup W={W} Q={Q}, rows of {R * 4} bytes: exact; "
                      f"kernel {ms:.4f} ms ({Q / ms / 1e3:.2f}M lookups/s), "
                      f"plain {plain:.4f} ms; "
                      f"{nrows / max(1, int((rows > 0).sum())):.4f} rows read "
                      f"per live query (most {int(rows.max())}), row bytes "
                      f"{rate / 1e9:.1f} GB/s = "
                      f"{100 * rate / HBM_BYTES_S:.1f} % of 3.35 TB/s")
            hit = found.nonzero()[:, 0]
            if not torch.equal(keys[idx[hit].long()], q[hit]):
                fail(f"lookup W={W} Q={Q}: a found row holds another key")
            for other in (hashidx.lookup_planar(tplan, q, bplan, W),
                          sops.lookup_join(keys, q),
                          sops.lookup_join(keys, q, variant="mp")):
                if not (torch.equal(other[0], idx) and
                        torch.equal(other[1], found)):
                    fail(f"lookup W={W} Q={Q}: planar or a join disagrees")
            planar = time_ms(
                torch, lambda: hashidx.lookup_planar(tplan, q, bplan, W), 5)
            join = time_ms(torch, lambda: sops.lookup_join(keys, q), 3)
            join_mp = time_ms(
                torch, lambda: sops.lookup_join(keys, q, variant="mp"), 3)
            print(f"lookup W={W} Q={Q}: {int(found.sum())} found; "
                  f"lookup_planar {planar:.4f} ms, lookup_join {join:.4f} ms, "
                  f"lookup_join mp {join_mp:.4f} ms")
            if W == 1 and Q == N_STORE:
                ks, qs = keys[:, 0] ^ SIGN, (q[:, 0] ^ SIGN).contiguous()
                lib = time_ms(torch, lambda: torch.searchsorted(ks, qs), 5)
                print(f"lookup W={W} Q={Q}: torch.searchsorted of the "
                      f"queries in the sorted keys {lib:.4f} ms")
                # every table row that a probe reads, once, at the row
                # bytes of the table in use; the queries, idx and found;
                # per query the hash and one compare per row word
                ms, plain, rows, bb = timed[32]
                results["lookup"] = row(
                    err, ms, plain,
                    rows_named(torch, kops, q, rows, bb) * 32 * 4
                    + nbytes_of(q, idx, found), Q * (24 + 32), lib)
                del ks, qs
        del keys, tables, tplan, q, idx, found, timed, rows, table
        torch.cuda.empty_cache()

    # a table filled almost to the brim by a forced small b_bits: chains of
    # many rows, some past the last row
    for W, n, bb in CROWDED:
        S = lookup.slots_for(W, 32)
        # random keys, and some three rows' worth whose home is the last row
        pool = rng.integers(0, 1 << 62, size=(3 * S << bb, W),
                            dtype=np.uint64)
        pool = pool[hashidx._hash_np(pool) >> np.uint64(64 - bb)
                    == (1 << bb) - 1]
        keys_np = np.unique(np.concatenate([pool, rng.integers(
            0, 1 << 62, size=(n, W), dtype=np.uint64)]), axis=0)
        n = len(keys_np)
        table_np, got_b = lookup.build_table32(keys_np, b_bits=bb)
        if got_b != bb or len(pool) <= S:
            fail(f"crowded table W={W}: b_bits grew to {got_b}, or the last "
                 f"row does not overflow ({len(pool)} keys)")
        keys, table = on_card(keys_np, np.int64), on_card(table_np, np.int32)
        q = on_card(np.concatenate([keys_np,
                                    lookup_queries(rng, keys_np, 500_001)]),
                    np.int64)
        idx, found, _err = check_lookup(torch, f"crowded table W={W}", lookup,
                                        table, bb, q, W)
        want = sops.lookup_join(keys, q)
        if not (torch.equal(idx, want[0]) and torch.equal(found, want[1])):
            fail(f"crowded table W={W}: the kernel and the join disagree")
        if not (bool(found[:n].all()) and torch.equal(
                idx[:n], torch.arange(n, device=dev, dtype=torch.int32))):
            fail(f"crowded table W={W}: a stored key is not found in its row")
        rows = lookup.rows_read(table, q, bb, W)
        home = hashidx._hash_np(keys_np) >> np.uint64(64 - bb)
        last = home == (1 << bb) - 1
        wrapped = int((rows[:n][torch.from_numpy(last).to(dev)] > 1).sum())
        if int(rows.max()) < 3 or wrapped == 0:
            fail(f"crowded table W={W}: no chain of 3 rows, or none past the "
                 f"last row")
        print(f"lookup crowded table W={W}: {n} keys in 2^{bb} rows of {S} "
              f"slots (fill {n / (S << bb):.3f}), {q.shape[0]} queries: exact "
              f"against plain and the join; "
              f"{float(rows[rows > 0].float().mean()):.3f} rows read per live "
              f"query, most {int(rows.max())}; {wrapped} keys of the last "
              f"row found past it")
        del keys, table, q, idx, found, rows
    torch.cuda.empty_cache()


def run_cli(argv):
    """The port's CLI entry point in-process; returns its stderr."""
    from mccortex_tpu_torch.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = main(argv)
    err = buf.getvalue()
    sys.stderr.write(err)
    if rc != 0:
        fail(f"mctx-torch {' '.join(argv)} exited {rc}")
    return err


def build_under(engine: str, argv, required=None):
    """One `mctx-torch build` through the CLI under a sort engine, with
    the launch counts set to 0 just before and read just after.  Returns
    (stderr, wall seconds, launches)."""
    from mccortex_tpu_torch.graph import build as gbuild
    from mccortex_tpu_torch.ops.kernels import _build

    saved = gbuild.SORT_IMPL
    gbuild.SORT_IMPL = engine
    try:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        log = run_cli(argv)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        gbuild.SORT_IMPL = saved
    print(f"launches of mctx-torch build under MCTX_SORT={engine}: "
          f"{json.dumps(launches)}")
    for name in ENGINE_KERNELS[engine] if required is None else required:
        if launches.get(name, 0) <= 0:
            fail(f"the build under {engine} never launched the {name} kernel")
    for name in set(ENGINE_KERNELS["mp"] + ENGINE_KERNELS["bitonic"]) \
            - set(ENGINE_KERNELS[engine]):
        if launches.get(name, 0):
            fail(f"the build under {engine} launched the {name} kernel")
    return log, wall, launches


def build_seconds(log: str) -> float:
    m = re.search(r"built (\d+) kmers from (\d+) batches in ([\d.]+)s", log)
    return float(m.group(3)) if m else float("nan")


def read_span(log: str):
    """(seconds, reader name) of a build's "read N batches" line."""
    m = re.search(r"read \d+ batches in ([\d.]+)s \((\w+) reader\)", log)
    return (float(m.group(1)), m.group(2)) if m else (float("nan"), None)


def write_seconds(log: str) -> float:
    m = re.search(r"wrote \d+ kmers x \d+ colours to .* in ([\d.]+)s", log)
    return float(m.group(1)) if m else float("nan")


@contextlib.contextmanager
def python_reader():
    """Builds inside read through the port's Python parser: the native
    library reads as unavailable."""
    from mccortex_tpu_torch import native
    saved = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = saved


def phase_ingest(fq: str, nreads: int) -> dict:
    """4a: the E. coli FASTQ through the Python reader and the native
    reader, without and with prefetch, as `build` reads it (overlap k):
    the batches must be equal; the seconds of each."""
    from mccortex_tpu_torch import native
    from mccortex_tpu_torch.io import seqio

    gpp = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    t0 = time.perf_counter()
    lib = native.get_lib()
    if lib is None:
        fail(f"the native reader did not build or load: {native.LOG}")
    print(f"native reader: {os.path.relpath(native.SO, HERE)} built from "
          f"{os.path.relpath(native.SRC, HERE)} in "
          f"{time.perf_counter() - t0:.2f}s by "
          f"{gpp.stdout.splitlines()[0] if gpp.stdout else 'g++'} "
          f"(zlib.h and -lz found)")

    def run(prefetch):
        t0 = time.perf_counter()
        got = list(seqio.read_batches_native([fq], overlap=K_MAIN,
                                             prefetch=prefetch))
        return got, time.perf_counter() - t0

    secs = {}
    nat0, secs["native"] = run(0)
    natp, secs["native_prefetch"] = run(4)
    with python_reader():
        if seqio.reader_name() != "python":
            fail("the Python reader could not be selected")
        py, secs["python"] = run(0)
    for label, other in (("native with prefetch", natp), ("python", py)):
        if len(other) != len(nat0):
            fail(f"ingest: the {label} reader gave {len(other)} batches, "
                 f"the native {len(nat0)}")
        for (a, qa, _), (b, qb, _) in zip(nat0, other):
            if not np.array_equal(a, b) or (qa is None) != (qb is None) or \
                    (qa is not None and not np.array_equal(qa, qb)):
                fail(f"ingest: the {label} reader's batches differ from the "
                     f"native reader's")
    rows = sum(c.shape[0] for c, _q, _col in nat0)
    if rows != nreads:
        fail(f"ingest: {rows} rows for {nreads} reads")
    print(f"ingest of {nreads} reads ({os.path.getsize(fq)} bytes of FASTQ, "
          f"{len(nat0)} batches): python reader {secs['python']:.3f}s, "
          f"native {secs['native']:.3f}s, native with prefetch "
          f"{secs['native_prefetch']:.3f}s "
          f"({secs['python'] / secs['native_prefetch']:.1f}x); the three "
          f"give equal batches")
    return secs


def count_kmers_np(reads: np.ndarray, k: int):
    want = [canonical_kmers_np(reads[s:s + 100_000], k)
            for s in range(0, len(reads), 100_000)]
    return np.unique(np.concatenate(want), return_counts=True)


def phase_main_path(torch, tmp, card):
    from mccortex_tpu_torch.io import ctx as ctxio

    t0 = time.perf_counter()
    genome, reads, starts = genome_and_reads(GENOME_BP, 20.0, seed=0)
    fq = os.path.join(tmp, "reads.fq")
    write_fastq(fq, reads)
    print(f"E. coli-sized input: {len(genome)} bp genome, {len(reads)} reads "
          f"x {reads.shape[1]} bp (made in {time.perf_counter() - t0:.1f}s)")
    obs = valid_windows_np(reads, K_MAIN)
    phase_ingest(fq, len(reads))
    # lax runs first and last: the spread of two runs of one engine on a
    # shared host stands beside the differences between engines; then
    # one lax build through the Python reader, the CLI wall before the
    # native reader
    out, ref, launches = None, None, {}
    for turn, (engine, reader) in enumerate((
            ("lax", "native"), ("mp", "native"), ("bitonic", "native"),
            ("lax", "native"), ("lax", "python"))):
        path = os.path.join(tmp, f"ecoli_{turn}.ctx")
        with python_reader() if reader == "python" else \
                contextlib.nullcontext():
            log, wall, launched = build_under(
                engine, ["build", "-k", str(K_MAIN), "--sample", "ecoli",
                         "--seq", fq, path, "--device", "cuda"])
        if reader == "native":
            launches[engine] = launched
        build_s = build_seconds(log)
        read_s, read_by = read_span(log)
        if read_by != reader:
            fail(f"the build read through the {read_by} reader, not the "
                 f"{reader} one")
        write_s = write_seconds(log)
        print(f"main path on {card} under MCTX_SORT={engine}, {reader} "
              f"reader: mctx-torch build wall {wall:.3f}s ({obs / wall / 1e6:.2f}"
              f"M kmer-obs/s) = read {read_s:.3f}s + graph build "
              f"{build_s:.3f}s ({obs / build_s / 1e6:.2f}M kmer-obs/s) + "
              f"write {write_s:.3f}s + other "
              f"{wall - read_s - build_s - write_s:.3f}s, {obs} kmer-obs")
        if out is None:
            out, ref = path, open(path, "rb").read()
            continue
        if open(path, "rb").read() != ref:
            fail(f"the .ctx built under {engine} differs from the first lax "
                 f"one")
        os.remove(path)
    print(f"main path: the .ctx of {len(ref)} bytes is byte-identical under "
          f"lax, mp and bitonic, and through the Python reader")
    del ref
    profile_build(torch, reads)

    h, keys, covg, _edges = ctxio.read_ctx(out)
    kv = keys[:, 0]
    if len(kv) == 0 or not (kv[1:] > kv[:-1]).all():
        fail("the .ctx keys are not strictly increasing")
    if int(covg.sum(dtype=np.uint64)) != obs:
        fail(f"sum of covg {int(covg.sum())} != {obs} kmer windows")
    ukeys, counts = count_kmers_np(reads, K_MAIN)
    if not (np.array_equal(ukeys, kv) and
            np.array_equal(counts, covg[:, 0].astype(np.int64))):
        fail("the .ctx kmers/coverage differ from the numpy count of the "
             "reads' kmers")
    # every genome kmer inside a read window free of substitutions
    rlen = reads.shape[1]
    changed = reads != np.lib.stride_tricks.sliding_window_view(
        genome, rlen)[starts]
    bad = np.concatenate([np.zeros((len(reads), 1), np.int32),
                          np.cumsum(changed, axis=1, dtype=np.int32)], axis=1)
    clean = bad[:, K_MAIN:] - bad[:, :rlen - K_MAIN + 1] == 0
    covered = np.zeros(len(genome) - K_MAIN + 1, bool)
    r, j = np.nonzero(clean)
    covered[starts[r] + j] = True
    gk = canonical_kmers_np(genome[None, :], K_MAIN)[covered]
    if not np.isin(gk, kv).all():
        fail("a genome kmer covered by an error-free read window is missing")
    print(f"main path: {len(kv)} kmers (numpy reference equal), "
          f"{int(covered.sum())} covered genome kmers all present")
    return launches, genome, reads, starts, out


def profile_build(torch, reads):
    """One graph build of the E. coli reads under lax (graph.build.build,
    batches of 2048 reads as the CLI makes them) under torch.profiler:
    the device time of the front-end and segreduce kernels summed over
    the build, every device operation, and the device's busy share of
    the profiled wall."""
    from mccortex_tpu_torch.graph import build as gbuild
    batches = [(reads[s:s + 2048], 0) for s in range(0, len(reads), 2048)]
    saved, gbuild.SORT_IMPL = gbuild.SORT_IMPL, "lax"
    try:
        gbuild.build(batches[:4], K_MAIN)
        got = {}
        kinds, us, wall = device_profile(
            torch, lambda: got.update(g=gbuild.build(batches, K_MAIN)))
    finally:
        gbuild.SORT_IMPL = saved
    if not sum(kinds.values()):
        print("profiled lax build: the profiler saw no device activity "
              "(device times not measured)")
        return
    fe = sum(v for k, v in us.items() if "frontend_kernel" in k)
    sr = sum(v for k, v in us.items() if "seg_kernel" in k)
    fill = sum(v for k, v in us.items() if "seg_fill" in k)
    busy = sum(us.values())
    top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
    print(f"profiled lax build ({len(batches)} epochs, {got['g'].n} kmers): "
          f"wall {wall:.3f}s under the profiler, device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.1f} %; device "
          f"operations {json.dumps(kinds)}; front-end kernel "
          f"{fe / 1e3:.3f} ms, segreduce kernel {sr / 1e3:.3f} ms + its fill "
          f"{fill / 1e3:.3f} ms; largest: "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))


def start_tokens_np(reads: np.ndarray, k: int) -> np.ndarray:
    """(canonical start kmer, orientation) of every N-free read as one
    Python-hashable integer: the token of the PCR duplicate rule."""
    head = reads[:, :k].astype(np.uint64)
    fw = np.zeros(len(reads), np.uint64)
    rc = np.zeros(len(reads), np.uint64)
    for t in range(k):
        fw = (fw << np.uint64(2)) | head[:, t]
        rc = (rc >> np.uint64(2)) | ((np.uint64(3) - head[:, t])
                                     << np.uint64(2 * k - 2))
    return np.stack([np.minimum(fw, rc), (rc < fw).astype(np.uint64)], axis=1)


def phase_paired(torch, tmp, card, genome, reads):
    """The E. coli reads as mate pairs with planted duplicate pairs:
    `build -p` through --seq2 and through --seqi, and --intersect."""
    from mccortex_tpu_torch.io import ctx as ctxio

    rng = np.random.default_rng(5)
    npairs = len(reads) // 2
    r1, r2 = reads[0:2 * npairs:2].copy(), reads[1:2 * npairs:2].copy()
    planted = rng.choice(np.arange(1000, npairs), npairs // 20, replace=False)
    src = rng.integers(0, planted)          # an earlier pair, both mates
    order = np.argsort(planted)
    for i, j in zip(planted[order], src[order]):
        r1[i], r2[i] = r1[j], r2[j]
    # the rule, one pair after another: a pair goes when both mates' start
    # tokens were seen before as read starts; every read's tokens count
    t1 = [tuple(t) for t in start_tokens_np(r1, K_MAIN).tolist()]
    t2 = [tuple(t) for t in start_tokens_np(r2, K_MAIN).tolist()]
    seen, keep = set(), np.ones(npairs, bool)
    for i in range(npairs):
        keep[i] = not (t1[i] in seen and t2[i] in seen)
        seen.add(t1[i])
        seen.add(t2[i])
    ndrop = int((~keep).sum())
    if keep[planted].any() or ndrop < len(planted):
        fail("the reference of the PCR rule kept a planted duplicate pair")

    fq1, fq2 = os.path.join(tmp, "m1.fq"), os.path.join(tmp, "m2.fq")
    fqi = os.path.join(tmp, "mi.fq")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    inter = np.empty((2 * npairs, reads.shape[1]), np.uint8)
    inter[0::2], inter[1::2] = r1, r2
    write_fastq(fqi, inter)
    gfa = os.path.join(tmp, "genome.fa")
    with open(gfa, "wb") as fh:
        fh.write(b">genome\n" + np.frombuffer(b"ACGT", np.uint8)[genome]
                 .tobytes() + b"\n")

    base = ["build", "-k", str(K_MAIN), "-p", "--sample", "pairs"]
    outs = {}
    for name, task in (("seq2", ["--seq2", f"{fq1}:{fq2}"]),
                       ("seqi", ["--seqi", fqi])):
        outs[name] = os.path.join(tmp, f"pairs_{name}.ctx")
        log, wall, _ = build_under(
            "lax", base + task + [outs[name], "--device", "cuda"])
        m = re.search(r"removed (\d+) PCR duplicate reads", log)
        if not m or int(m.group(1)) != 2 * ndrop:
            fail(f"build -p {name}: removed {m and m.group(1)} reads, the "
                 f"rule removes {2 * ndrop}")
        print(f"paired build -p through --{name} on {card}: wall {wall:.3f}s, "
              f"graph build {build_seconds(log):.3f}s, removed {2 * ndrop} "
              f"reads = {ndrop} pairs ({len(planted)} planted, the rest start "
              f"where earlier reads start)")
    if open(outs["seq2"], "rb").read() != open(outs["seqi"], "rb").read():
        fail("the --seq2 and --seqi .ctx files differ")
    _h, keys, covg, _e = ctxio.read_ctx(outs["seq2"])
    ukeys, counts = count_kmers_np(np.concatenate([r1[keep], r2[keep]]),
                                   K_MAIN)
    if not (np.array_equal(ukeys, keys[:, 0]) and
            np.array_equal(counts, covg[:, 0].astype(np.int64))):
        fail("build -p: the .ctx differs from the numpy count of the kept "
             "pairs' kmers")
    print(f"paired build -p: --seq2 == --seqi byte for byte, {len(ukeys)} "
          f"kmers equal to the numpy count of the kept pairs")

    gctx = os.path.join(tmp, "genome.ctx")
    build_under("lax", ["build", "-k", str(K_MAIN), "--sample", "genome",
                        "--seq", gfa, gctx, "--device", "cuda"])
    ictx = os.path.join(tmp, "pairs_in_genome.ctx")
    log, wall, _ = build_under(
        "lax", base + ["--seq2", fq1, fq2, "--intersect", gctx, ictx,
                       "--device", "cuda"])
    hi_, ikeys, icovg, _e = ctxio.read_ctx(ictx)
    gk = np.unique(canonical_kmers_np(genome[None, :], K_MAIN))
    _h, gkeys, _c, _e = ctxio.read_ctx(gctx)
    if not np.array_equal(gkeys[:, 0], gk):
        fail("the genome's graph differs from the genome's kmers")
    shared = np.isin(ukeys, gk)
    if not (np.array_equal(ikeys[:, 0], ukeys[shared]) and
            np.array_equal(icovg[:, 0].astype(np.int64), counts[shared])):
        fail("--intersect did not keep exactly the kmers shared with the "
             "genome's graph, with their coverage")
    if not hi_.ginfo[0].cleaning.is_graph_intersection:
        fail("--intersect did not mark the header")
    print(f"build -p --intersect: wall {wall:.3f}s; kept {len(ikeys)} of "
          f"{len(ukeys)} kmers, exactly those among the genome's {len(gk)}")


def revcomp_np(x: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of k <= 31 kmers in uint64."""
    x = ~x
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        m = np.uint64(m)
        x = ((x & m) << np.uint64(sh)) | ((x >> np.uint64(sh)) & m)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def read_fasta_seqs(path: str) -> list:
    with open(path, "rb") as fh:
        return [l.strip() for l in fh if not l.startswith(b">")]


def check_unitig_partition(seqs: list, keys: np.ndarray, k: int) -> int:
    """The canonical kmers of all unitigs, taken together, are exactly
    the sorted key set, each once.  Returns the number of unitigs."""
    lens = np.array([len(s) for s in seqs], np.int64)
    if (lens < k).any():
        fail("a unitig is shorter than k")
    codes = CHAR_CODES[np.frombuffer(b"".join(seqs), np.uint8)]
    if (codes > 3).any():
        fail("a unitig holds a base other than ACGT")
    km = canonical_kmers_np(codes[None, :], k)
    offs = np.concatenate([[0], np.cumsum(lens)])
    inside = np.zeros(len(km), bool)
    nk = lens - k + 1
    starts = np.repeat(offs[:-1], nk) + (
        np.arange(nk.sum()) - np.repeat(np.cumsum(nk) - nk, nk))
    inside[starts] = True
    got = np.sort(km[inside])
    if len(got) != len(keys) or not np.array_equal(got, keys):
        fail(f"the unitigs' {len(got)} kmers are not the graph's "
             f"{len(keys)} kmers, each once")
    return len(seqs)


def check_edges_closed(keys: np.ndarray, edges: np.ndarray, k: int):
    """Every edge bit points at a kmer of the graph (k <= 31, 1 colour
    or the union of colours)."""
    ue = np.bitwise_or.reduce(edges, axis=1)
    mask = np.uint64((1 << (2 * k)) - 1)
    for o in (0, 1):
        okm = keys if o == 0 else revcomp_np(keys, k)
        for n in range(4):
            rows = np.nonzero((ue >> (n + 4 * o)) & 1)[0]
            nxt = ((okm[rows] << np.uint64(2)) | np.uint64(n)) & mask
            nkey = np.minimum(nxt, revcomp_np(nxt, k))
            pos = np.searchsorted(keys, nkey)
            if not (pos < len(keys)).all() or \
                    not np.array_equal(keys[pos], nkey):
                fail(f"an edge (orient {o}, base {n}) of the cleaned graph "
                     f"points at a kmer it does not hold")


def time_split(log: str) -> str:
    m = re.findall(r"time split: (.*)", log)
    return m[-1] if m else "missing"


def phase_graph_path(torch, tmp, card, raw, genome):
    """4b: clean and unitigs on the E. coli graph, through the CLI."""
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.ops.kernels import _build

    cln = os.path.join(tmp, "clean.ctx")
    fa = os.path.join(tmp, "unitigs.fa")
    walls, lookups = {}, 0
    for name, argv in (("clean", ["clean", "-T", "-U", "-o", cln, raw]),
                       ("unitigs", ["unitigs", "-o", fa, cln])):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        log = run_cli(argv + ["--device", "cuda"])
        walls[name] = time.perf_counter() - t0
        launched = dict(_build.LAUNCHES)
        print(f"launches in mctx-torch {name}: {json.dumps(launched)}")
        if launched.get("lookup", 0) <= 0:
            fail(f"mctx-torch {name} never launched the lookup kernel")
        lookups += launched["lookup"]
        print(f"graph path on {card}: mctx-torch {name} wall "
              f"{walls[name]:.3f}s; split: {time_split(log)}")
        if name == "clean":
            m = re.search(r"auto cleaning threshold: <(\d+)", log)
            if not m:
                fail("clean did not pick a coverage threshold")
            thresh = int(m.group(1))

    _h, rkeys, rcovg, _re = ctxio.read_ctx(raw)
    _h, ckeys, ccovg, cedges = ctxio.read_ctx(cln)
    rk, ck = rkeys[:, 0], ckeys[:, 0]
    pos = np.searchsorted(rk, ck)
    if not (pos < len(rk)).all() or not np.array_equal(rk[pos], ck):
        fail("the cleaned graph holds a kmer the raw graph does not")
    if not np.array_equal(rcovg[pos], ccovg):
        fail("cleaning changed the coverage of a kept kmer")
    if not len(ck) < len(rk):
        fail(f"clean kept all {len(rk)} kmers")
    check_edges_closed(ck, cedges, K_MAIN)
    nu = check_unitig_partition(read_fasta_seqs(fa), ck, K_MAIN)
    gk = np.unique(canonical_kmers_np(genome[None, :], K_MAIN))
    in_genome = int(np.isin(ck, gk).sum())
    print(f"graph path: threshold <{thresh}; {len(rk)} -> {len(ck)} kmers, "
          f"{in_genome} genome kmers kept of {len(gk)}, "
          f"{len(ck) - in_genome} non-genome kmers kept; {nu} unitigs "
          f"partition the cleaned kmers exactly; every edge closed")
    return lookups


def phase_kograph(torch, raw, genome, gfa):
    """4c: the reference-position index of the E. coli graph against its
    genome (graph/kmer_occur.build_kograph), which must launch the lookup
    kernel; its CSR is held against a numpy index of the genome's
    kmers."""
    from mccortex_tpu_torch.graph import kmer_occur as ko
    from mccortex_tpu_torch.graph import store as gstore
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.ops.kernels import _build

    _h, keys, covg, edges = ctxio.read_ctx(raw)
    g = gstore.from_host(keys, covg, edges, K_MAIN, "cuda")
    ref = ko.RefGenome.from_fasta(gfa)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    kg = ko.build_kograph(g, ref)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = dict(_build.LAUNCHES)
    if launched.get("lookup", 0) <= 0:
        fail("build_kograph never launched the lookup kernel")
    fw, rc = kmers_np(genome[None, :], K_MAIN)
    gk = np.minimum(fw, rc)
    kv = keys[:, 0]
    at = np.minimum(np.searchsorted(kv, gk), len(kv) - 1)
    hit = kv[at] == gk
    pos = np.nonzero(hit)[0]
    rows = at[hit]
    order = np.lexsort((pos, rows))
    offsets = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=len(kv)))])
    if not (np.array_equal(kg.offsets.numpy(), offsets)
            and np.array_equal(kg.pos.numpy(), pos[order])
            and np.array_equal(kg.orient.numpy(),
                               (rc < fw)[hit][order].astype(np.uint8))
            and not kg.chrom.numpy().any()):
        fail("build_kograph's CSR differs from the numpy index of the "
             "genome's kmers")
    print(f"kmer_occur.build_kograph of the {len(kv)}-kmer graph against the "
          f"{len(genome)} bp genome: {kg.noccurs} occurrences, equal to the "
          f"numpy index; {secs:.3f}s (launches {json.dumps(launched)})")
    del g


def codes_of(seq: bytes) -> np.ndarray:
    return CHAR_CODES[np.frombuffer(seq, np.uint8)]


def neighbour_keys_np(keys: np.ndarray, o: int, n: int, k: int) -> np.ndarray:
    """Canonical key of the kmer reached from each key (k <= 31) read in
    orientation o by appending base n."""
    okm = keys if o == 0 else revcomp_np(keys, k)
    nxt = ((okm << np.uint64(2)) | np.uint64(n)) & np.uint64((1 << 2 * k) - 1)
    return np.minimum(nxt, revcomp_np(nxt, k))


def rows_of(keys: np.ndarray, q: np.ndarray):
    """(row, found) of each query key in the sorted keys.  The queries
    are searched in their sorted order, which keeps the search's reads
    of the keys in cache (5x faster for 8M queries in 4M keys)."""
    flat = q.reshape(-1)
    order = np.argsort(flat)
    pos = np.empty(flat.shape, np.int64)
    pos[order] = np.minimum(np.searchsorted(keys, flat[order]),
                            len(keys) - 1)
    pos = pos.reshape(q.shape)
    return pos, keys[pos] == q


def check_contigs(seqs: list, keys: np.ndarray, genome: np.ndarray, k: int,
                  label: str) -> dict:
    """Every contig's canonical kmers are kmers of the graph, and the
    longest contig is a substring of the genome or of its reverse
    complement (numpy, independent of the port).  Returns N50 and
    lengths."""
    if not seqs:
        fail(f"{label}: no contigs")
    for s in seqs:
        c = codes_of(s)
        if len(c) < k or (c > 3).any():
            fail(f"{label}: a contig of {len(c)} bases is shorter than k or "
                 f"holds a base other than ACGT")
        if not rows_of(keys, canonical_kmers_np(c[None, :], k))[1].all():
            fail(f"{label}: a contig holds a kmer the graph does not")
    best = max(seqs, key=len)
    fw = np.frombuffer(b"ACGT", np.uint8)[genome].tobytes()
    rc = np.frombuffer(b"ACGT", np.uint8)[3 - genome[::-1]].tobytes()
    if best not in fw and best not in rc:
        fail(f"{label}: the longest contig ({len(best)} bp) is not a "
             f"substring of the genome or of its reverse complement")
    lens = np.sort(np.array([len(s) for s in seqs]))[::-1]
    n50 = int(lens[np.searchsorted(np.cumsum(lens), lens.sum() / 2)])
    return dict(n=len(seqs), max=int(lens[0]), n50=n50,
                total=int(lens.sum()))


def check_inferred(before: str, after: str, k: int) -> int:
    """inferedges only adds edge bits, and each new bit of colour c joins
    two kmers that both have coverage in c (infer_edges.py's rule, in
    numpy).  Returns the number of bits added."""
    from mccortex_tpu_torch.io import ctx as ctxio
    _h, keys, covg, edges = ctxio.read_ctx(before)
    _h, keys2, covg2, edges2 = ctxio.read_ctx(after)
    keys, keys2 = keys[:, 0], keys2[:, 0]
    if not (np.array_equal(keys, keys2) and np.array_equal(covg, covg2)):
        fail("inferedges changed the kmers or their coverage")
    if (edges & ~edges2).any():
        fail("inferedges removed an edge bit")
    added = edges2 & ~edges
    for o in (0, 1):
        for n in range(4):
            bit = np.uint8(1 << (n + 4 * o))
            r, c = np.nonzero(added & bit)
            if not len(r):
                continue
            j, found = rows_of(keys, neighbour_keys_np(keys[r], o, n, k))
            if not (found & (covg[r, c] > 0) & (covg[j, c] > 0)).all():
                fail(f"inferedges added an edge (orient {o}, base {n}) "
                     f"that does not join two kmers covered in its colour")
    return int(np.unpackbits(added).sum())


class HopCounter:
    """Counts the hop walker's steps (graph/traverse._hop_step calls) and
    the contig batches walked (assemble_linkless_contigs calls), and
    keeps the arguments of the first step that has live walkers."""

    def __init__(self, T):
        self.T, self.hops, self.batches, self.first = T, 0, 0, None
        self._step, self._assemble = T._hop_step, T.assemble_linkless_contigs

    def __enter__(self):
        def step(hg, st, bufs, colour, max_len):
            self.hops += 1
            if self.first is None:
                self.first = (hg, st, [b.clone() for b in bufs], colour,
                              max_len)
            return self._step(hg, st, bufs, colour, max_len)

        def assemble(*a, **kw):
            self.batches += 1
            return self._assemble(*a, **kw)

        self.T._hop_step, self.T.assemble_linkless_contigs = step, assemble
        return self

    def __exit__(self, *exc):
        self.T._hop_step = self._step
        self.T.assemble_linkless_contigs = self._assemble


def lookups_of(argv, label) -> tuple:
    """One port command through the CLI on the card, with the launch
    counts set to 0 just before and read just after; it must launch the
    lookup kernel.  Returns (stderr, wall, lookup launches)."""
    from mccortex_tpu_torch.ops.kernels import _build
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    log = run_cli(argv + ["--device", "cuda"])
    wall = time.perf_counter() - t0
    launched = dict(_build.LAUNCHES)
    if launched.get("lookup", 0) <= 0:
        fail(f"mctx-torch {label} never launched the lookup kernel")
    return log, wall, launched["lookup"]


def phase_graph_walks(torch, tmp, card, genome) -> tuple:
    """4d: linkless contigs, edge inference and a subgraph on the cleaned
    E. coli graph of phase 4b, through the CLI on the card, each held to
    numpy checks; assemble_linkless_contigs with 256 seeds, cold and
    warm; one batch of the hop walker under torch.profiler.  Returns the
    lookup kernel's launches."""
    from mccortex_tpu_torch.graph import store as gstore
    from mccortex_tpu_torch.graph import traverse as T
    from mccortex_tpu_torch.io import ctx as ctxio

    cln = os.path.join(tmp, "clean.ctx")
    h, keys, covg, edges = ctxio.read_ctx(cln)
    kv = keys[:, 0]
    lookups = 0
    fa = os.path.join(tmp, "contigs.fa")
    with HopCounter(T) as hc:
        log, wall, nl = lookups_of(["contigs", "-o", fa, cln],
                                   "contigs")
    lookups += nl
    st = check_contigs(read_fasta_seqs(fa), kv, genome, K_MAIN,
                       "mctx-torch contigs")
    linkless_n50 = st["n50"]
    halts = re.search(r"contigs halt reasons: (.*)", log)
    print(f"graph walks on {card}: mctx-torch contigs of the {len(kv)}-kmer "
          f"cleaned graph (--batch 512, --max-len 65536, --no-reseed) wall "
          f"{wall:.3f}s; {hc.batches} batches walked of "
          f"{-(-len(kv) // 512)}, {st['n']} contigs, {hc.hops} hops; total "
          f"{st['total']} bp, max {st['max']}, N50 {st['n50']}; lookup "
          f"launches {nl}; halt reasons: "
          f"{halts.group(1) if halts else 'missing'}; split: "
          f"{time_split(log)}")
    if not halts:
        fail("contigs printed no halt-reason line")

    # the recipe of scripts/scale_test.py: 256 seeds, max_len 200,000
    g = gstore.from_host(keys, covg, edges, K_MAIN, "cuda")
    seeds = np.random.default_rng(0).integers(0, len(kv), 256)
    walls = []
    for turn in ("cold", "warm"):
        with HopCounter(T) as hc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            contigs, _stops = T.assemble_linkless_contigs(
                g, seeds, colour=0, max_len=200_000)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    st = check_contigs([c.encode() for c in contigs], kv, genome, K_MAIN,
                       "assemble_linkless_contigs")
    print(f"assemble_linkless_contigs, 256 seeds, max_len 200000: cold "
          f"{walls[0]:.3f}s (adjacency, unitig view and layout included), "
          f"warm {walls[1]:.3f}s; {hc.hops} hops; max {st['max']}, N50 "
          f"{st['n50']}; the longest is a genome substring")

    # one batch of the CLI (the first 512 rows) under torch.profiler, the
    # caches warm: device operations per hop and the device's busy share,
    # against the batch's wall under the profiler and without it
    batch = np.arange(min(512, len(kv)))

    def one_batch():
        T.assemble_linkless_contigs(g, batch, colour=0, max_len=65536)

    with HopCounter(T) as hc:
        kinds, us, pwall = device_profile(torch, one_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_batch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = sum(kinds.values())
    dev_s = sum(us.values()) / 1e6
    # ten hop steps on the state of the batch's first hop (each the same
    # step: the record buffers are written at the same places)
    hg, st0, bufs, colour, max_len = hc.first
    kinds1, us1, _w1 = device_profile(torch, lambda: [
        T._hop_step(hg, st0, bufs, colour, max_len) for _ in range(10)])
    per_hop = sum(kinds1.values()) / 10
    if ops == 0 or per_hop == 0:
        fail("torch.profiler saw no device operation of the hop walker")
    print(f"hop walker, one batch of 512 seeds under torch.profiler: "
          f"{hc.hops} hops, {ops} device operations ({json.dumps(kinds)}), "
          f"{ops / max(hc.hops, 1):.1f} per hop over the batch; a hop step "
          f"alone {per_hop:.1f} device operations, "
          f"{sum(us1.values()) / 10:.1f} us of device time; device time "
          f"{1e3 * dev_s:.3f} ms of the batch, busy {100 * dev_s / pwall:.1f}% "
          f"of its wall under the profiler ({pwall:.4f}s) and "
          f"{100 * dev_s / wall:.1f}% of its wall without ({wall:.4f}s)")
    del g

    # edge inference: --pop (the default) on the cleaned graph, where one
    # colour leaves nothing to add; then --all on a copy of it with 1 % of
    # its edge bits cleared, which must restore exactly those bits (--all
    # finds no other absent edge in a graph built from reads)
    cut = os.path.join(tmp, "clean_cut.ctx")
    rng = np.random.default_rng(6)
    clear = (np.uint8(1) << rng.integers(0, 8, edges.shape, dtype=np.uint8)) \
        * (rng.random(edges.shape) < 0.08).astype(np.uint8)
    cut_edges = edges & ~clear
    ncut = int(np.unpackbits(edges & clear).sum())
    ctxio.write_ctx(cut, h, keys, covg, cut_edges)
    for flags, src in (([], cln), (["--all"], cut)):
        inf = os.path.join(tmp, "inf.ctx")
        log, wall, nl = lookups_of(["inferedges"] + flags
                                   + ["-o", inf, "-f", src],
                                   "inferedges " + " ".join(flags))
        lookups += nl
        added = check_inferred(src, inf, K_MAIN)
        if src == cut:
            _h, _k2, _c2, inferred = ctxio.read_ctx(inf)
            if not np.array_equal(inferred, edges):
                fail("inferedges --all did not restore exactly the edge bits "
                     "cleared from the cleaned graph")
        print(f"graph walks: mctx-torch inferedges {' '.join(flags) or '--pop'}"
              f" of the cleaned graph{'' if src == cln else f' less {ncut} edge bits'}"
              f": wall {wall:.3f}s; {added} edge bits added, each joining two "
              f"kmers covered in its colour; lookup launches {nl}; split: "
              f"{time_split(log)}")

    # a subgraph around a 20 kb slice of the genome
    sl = genome[2_000_000:2_020_000]
    sfa = os.path.join(tmp, "slice.fa")
    with open(sfa, "wb") as fh:
        fh.write(b">slice\n" + np.frombuffer(b"ACGT", np.uint8)[sl].tobytes()
                 + b"\n")
    sub = os.path.join(tmp, "sub.ctx")
    log, wall, nl = lookups_of(["subgraph", "--seq", sfa, "--dist", "5",
                                "-o", sub, cln], "subgraph")
    lookups += nl
    _h, skeys, scovg, _se = ctxio.read_ctx(sub)
    sk = skeys[:, 0]
    j, found = rows_of(kv, sk)
    if not found.all() or not np.array_equal(covg[j], scovg):
        fail("the subgraph holds a kmer the cleaned graph does not, or "
             "changed its coverage")
    slk = np.unique(canonical_kmers_np(sl[None, :], K_MAIN))
    in_graph = slk[rows_of(kv, slk)[1]]
    if not rows_of(sk, in_graph)[1].all():
        fail("the subgraph misses a kmer of the slice that the cleaned "
             "graph holds")
    print(f"graph walks: mctx-torch subgraph --dist 5 of a 20 kb slice wall "
          f"{wall:.3f}s; {len(sk)} kmers, all in the cleaned graph, holding "
          f"all {len(in_graph)} slice kmers it has; lookup launches {nl}; "
          f"split: {time_split(log)}")
    return lookups, linkless_n50


def phase_byte_identity(torch, tmp):
    rng = np.random.default_rng(2)
    genome, reads0, _ = genome_and_reads(200_000, 10.0, seed=3)
    alt = genome.copy()
    snp = rng.random(len(alt)) < 0.005
    alt[snp] = (alt[snp] + 1) % 4
    nreads = len(reads0)
    st = rng.integers(0, len(alt) - 150, nreads)
    reads1 = np.lib.stride_tricks.sliding_window_view(alt, 150)[st].copy()
    reads1[rng.random(reads1.shape) < 0.002] = 4
    fq0, fq1 = os.path.join(tmp, "c0.fq"), os.path.join(tmp, "c1.fq")
    quals0 = rng.integers(2, 41, reads0.shape).astype(np.uint8)
    write_fastq(fq0, reads0, quals0)
    write_fastq(fq1, reads1)
    # colour a's reads as SAM, BAM and CRAM: each builds the FASTQ's bytes
    # (the qualities masked by -Q 5 included), on the card and on the CPU
    fmt = {"fastq": fq0}
    for name, writer in (("sam", write_sam), ("bam", write_bam),
                         ("cram", write_cram)):
        fmt[name] = os.path.join(tmp, f"c0.{name}")
        writer(fmt[name], reads0, quals0)
    want = None
    for name, path in fmt.items():
        walls = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"fmt_{name}_{dev}.ctx")
            t0 = time.perf_counter()
            log = run_cli(["build", "-k", str(K_MAIN), "-Q", "5", "--sample",
                           "a", "--seq", path, out, "--device", dev])
            walls[dev] = (time.perf_counter() - t0, read_span(log))
            data = open(out, "rb").read()
            if want is None:
                want = data
            elif data != want:
                fail(f"the {name} build on {dev} differs from the FASTQ "
                     f"build on the card")
        print(f"byte identity {name} -> .ctx (k={K_MAIN}, -Q 5, {len(reads0)} "
              f"reads): {len(want)} bytes, CUDA == CPU == the FASTQ build; "
              f"wall {walls['cuda'][0]:.3f}s on the card (read "
              f"{walls['cuda'][1][0]:.3f}s, {walls['cuda'][1][1]} reader), "
              f"{walls['cpu'][0]:.3f}s on the CPU")
    for k in (K_MAIN, 63):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = os.path.join(tmp, f"two_k{k}_{dev}.ctx")
            run_cli(["build", "-k", str(k), "-Q", "5", "-H", "8",
                     "--sample", "a", "--seq", fq0, "--sample", "b",
                     "--seq", fq1, outs[dev], "--device", dev])
        a = open(outs["cuda"], "rb").read()
        b = open(outs["cpu"], "rb").read()
        if a != b:
            fail(f"k={k}: the CUDA and CPU .ctx files differ")
        print(f"byte identity k={k}: 2-colour .ctx of {len(a)} bytes, "
              f"CUDA == CPU")
        if k != K_MAIN:
            continue
        for engine in ("mp", "bitonic"):
            for dev in ("cuda", "cpu"):
                path = os.path.join(tmp, f"two_{engine}_{dev}.ctx")
                build_under(engine, [
                    "build", "-k", str(k), "-Q", "5", "-H", "8", "--sample",
                    "a", "--seq", fq0, "--sample", "b", "--seq", fq1, path,
                    "--device", dev],
                    required=ENGINE_KERNELS[engine] if dev == "cuda" else ())
                if open(path, "rb").read() != a:
                    fail(f"k={k} under {engine} on {dev}: the .ctx differs "
                         f"from the lax one")
            print(f"byte identity k={k} under MCTX_SORT={engine}: CUDA == CPU "
                  f"== the lax .ctx")
    # an existing graph's colours slotted in before a paired colour with -p
    raw = os.path.join(tmp, f"two_k{K_MAIN}_cuda.ctx")
    got = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"graph_pairs_{dev}.ctx")
        log = run_cli(["build", "-k", str(K_MAIN), "-p", "--graph", raw,
                       "--sample", "c", "--seq2", fq0, fq1, path, "--device",
                       dev])
        got[dev] = (open(path, "rb").read(),
                    re.search(r"removed (\d+) PCR duplicate reads", log))
    if got["cuda"][0] != got["cpu"][0] or not got["cuda"][1] or \
            got["cuda"][1].group(1) != got["cpu"][1].group(1):
        fail("--graph + --seq2 -p: the CUDA and CPU builds differ")
    print(f"byte identity --graph + --seq2 -p (k={K_MAIN}): 3-colour .ctx of "
          f"{len(got['cpu'][0])} bytes, CUDA == CPU, "
          f"{got['cuda'][1].group(1)} reads removed on both")
    # clean and unitigs of the k=31 graph, on the card and on the CPU
    for name, argv, out in (
            ("clean -T -U", ["clean", "-T", "-U", "-o"], "c.ctx"),
            ("unitigs", ["unitigs", "-o"], "u.fa"),
            ("unitigs --gfa", ["unitigs", "--gfa", "-o"], "u.gfa")):
        got = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{dev}_{out}")
            src = os.path.join(tmp, f"{dev}_c.ctx") if out != "c.ctx" else raw
            t0 = time.perf_counter()
            run_cli(argv + [path, src, "--device", dev])
            got[dev] = (open(path, "rb").read(), time.perf_counter() - t0)
        if got["cuda"][0] != got["cpu"][0]:
            fail(f"{name}: the CUDA and CPU outputs differ")
        print(f"byte identity {name} (k={K_MAIN}): {len(got['cpu'][0])} "
              f"bytes, CUDA == CPU (wall {got['cuda'][1]:.3f}s on the card, "
              f"{got['cpu'][1]:.3f}s on the CPU)")
    phase_store_cmds(tmp, raw, os.path.join(tmp, "fmt_sam_cuda.ctx"))
    phase_graph_cmds(tmp, raw, genome)
    phase_link_cmds(tmp, raw, genome)
    phase_read_cmds(tmp, genome)
    elapsed("5e")
    phase_calling_cmds(tmp, genome)
    elapsed("5f")


def run_cli_out(argv) -> tuple:
    """The port's CLI in-process with stdout and stderr captured; returns
    (stdout, stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        err = run_cli(argv)
    return buf.getvalue(), err


def same_on_both(name, argv, outs=(), need=("lookup",)):
    """One port command on the card and on the CPU with the same output
    paths (a .ctp header records the command line): every file it writes
    under one of the prefixes `outs` (decompressed, the .ctp generator
    masked; the date is fixed), its standard output and its status lines
    (times dropped) must be equal, at least one file non-empty where
    `outs` is given, and the card's run must launch each kernel of
    `need`.  Returns (files, stdout, status, card wall, CPU wall, card
    launches); the files on disk are the CPU's."""
    import glob
    import gzip
    from mccortex_tpu_torch.ops.kernels import _build
    got = {}
    strftime = time.strftime
    time.strftime = lambda fmt, *a: "2026-01-01 00:00:00"
    try:
        for dev in ("cuda", "cpu"):
            for o in outs:
                for f in glob.glob(o + "*"):
                    os.remove(f)
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            text, err = run_cli_out(argv + ["--device", dev])
            wall = time.perf_counter() - t0
            files = {}
            for o in outs:
                for f in sorted(glob.glob(o + "*")):
                    data = open(f, "rb").read()
                    if data[:2] == b"\x1f\x8b":
                        data = gzip.decompress(data)
                    files[os.path.basename(f)] = re.sub(
                        rb'"generator": "[^"]*"', b"", data)
            got[dev] = (files, text, re.sub(r"[\d.]+s\b", "", re.sub(
                r"time split: .*", "", err)), wall, dict(_build.LAUNCHES))
    finally:
        time.strftime = strftime
    if got["cuda"][:3] != got["cpu"][:3]:
        fail(f"{name}: the CUDA and CPU outputs differ")
    if outs and not any(got["cpu"][0].values()):
        fail(f"{name} wrote no output")
    for kernel in need:
        if got["cuda"][4].get(kernel, 0) <= 0:
            fail(f"{name} on the card never launched the {kernel} kernel")
    return got["cpu"][:3] + (got["cuda"][3], got["cpu"][3], got["cuda"][4])


def phase_store_cmds(tmp, two, one):
    """5b: the store-only commands on the k=31 graphs (`two`: 2 colours,
    `one`: 1 colour), on the card and on the CPU: output bytes, text and
    status lines equal; the kernels each launches on the card."""
    from mccortex_tpu_torch.io import ctx as ctxio

    h, keys, covg, edges = ctxio.read_ctx(two)
    perm = np.random.default_rng(4).permutation(len(keys))
    scrambled = os.path.join(tmp, "scrambled.ctx")
    ctxio.write_ctx(scrambled, h, keys[perm], covg[perm], edges[perm])
    cases = (  # name, argv with OUT for the output file, kernels required
        ("join", ["join", "-o", "OUT", two, one], ("segreduce",)),
        ("join --flatten", ["join", "--flatten", "-o", "OUT", two, one],
         ("segreduce",)),
        ("join -i", ["join", "-i", one, "-o", "OUT", two],
         ("segreduce", "lookup")),
        ("check", ["check", two], ()),
        ("view -k -i", ["view", "-k", "-i", two], ()),
        ("dist", ["dist", "-o", "OUT", two], ()),
        ("sort", ["sort", "-o", "OUT", scrambled], ()),
        ("index", ["index", "-b", "1000", "-o", "OUT", two], ()))
    out = os.path.join(tmp, "cmd_out")
    for name, argv, need in cases:
        files, text, _st, wcard, wcpu, launched = same_on_both(
            name, [out if a == "OUT" else a for a in argv],
            [out] if "OUT" in argv else [], need)
        data = files.get("cmd_out", b"")
        if name == "sort" and data != open(two, "rb").read():
            fail("sort did not restore the sorted graph")
        print(f"store command {name} (k={K_MAIN}): "
              f"{len(data) + len(text)} bytes out, CUDA "
              f"== CPU; wall {wcard:.3f}s on the card "
              f"(launches {json.dumps(launched)}), "
              f"{wcpu:.3f}s on the CPU")


def phase_graph_cmds(tmp, two, genome):
    """5c: contigs, inferedges, subgraph -U and pjoin on the k=31
    two-colour graph, on the card and on the CPU: the same FASTA and .ctx
    bytes, and the same decompressed .ctp text with the date fixed.  The
    link file is written by the port's save_ctp from random links."""
    from mccortex_tpu_torch.cli.commands import _load_graph
    from mccortex_tpu_torch.io import ctp
    from mccortex_tpu_torch.links import store as lstore

    rng = np.random.default_rng(5)
    g = _load_graph(two, "cpu")[1]
    L = 20_000
    links = lstore.build_store(
        g.keys, rng.integers(0, g.n, L), rng.integers(0, 2, L),
        rng.integers(0, 4, (L, 48)).astype(np.uint8), rng.integers(1, 49, L),
        rng.integers(0, 2, L), 2)
    ctp_in = os.path.join(tmp, "links.ctp.gz")
    ctp.save_ctp(ctp_in, g, links, sample_names=["a", "b"])
    del g
    sfa = os.path.join(tmp, "slice5.fa")
    with open(sfa, "wb") as fh:
        fh.write(b">slice\n" + np.frombuffer(b"ACGT", np.uint8)[
            genome[50_000:52_000]].tobytes() + b"\n")
    cases = (
        ("contigs -N 64", ["contigs", "-N", "64", "-o", "OUT", two]),
        ("inferedges", ["inferedges", "-o", "OUT", two]),
        ("subgraph -U", ["subgraph", "--seq", sfa, "-U", "--dist", "2", "-o",
                         "OUT", two]),
        ("pjoin -r", ["pjoin", "-r", "-o", "OUT", two, ctp_in, ctp_in]))
    out = os.path.join(tmp, "g5c_out")
    for name, argv in cases:
        files, _t, _st, wcard, wcpu, launched = same_on_both(
            name, [out if a == "OUT" else a for a in argv], [out],
            () if name == "pjoin -r" else ("lookup",))
        extra = ""
        if name == "inferedges":
            added = check_inferred(two, out, K_MAIN)
            extra = (f"{added} edge bits added, each joining two kmers "
                     f"covered in its colour; ")
        print(f"graph command {name} (k={K_MAIN}, 2 colours): {extra}"
              f"{len(files['g5c_out'])} bytes out, CUDA == CPU; wall "
              f"{wcard:.3f}s on the card (launches "
              f"{json.dumps(launched)}), {wcpu:.3f}s on "
              f"the CPU")


class StepCounter:
    """Counts the linked walker's steps (links/walk._linked_step calls)
    and the linked contig batches (assemble_contigs_primed calls, summing
    their dropped pickups)."""

    def __init__(self, lwalk):
        self.lwalk, self.steps, self.batches, self.drops = lwalk, 0, 0, 0
        self._step = lwalk._linked_step
        self._primed = lwalk.assemble_contigs_primed

    def __enter__(self):
        def step(*a, **kw):
            self.steps += 1
            return self._step(*a, **kw)

        def primed(*a, **kw):
            self.batches += 1
            out = self._primed(*a, **kw)
            if len(out) == 3:
                self.drops += out[2]["n_drop"]
            return out

        self.lwalk._linked_step = step
        self.lwalk.assemble_contigs_primed = primed
        return self

    def __exit__(self, *exc):
        self.lwalk._linked_step = self._step
        self.lwalk.assemble_contigs_primed = self._primed


def parse_ctp_links(path: str):
    """Every link of a .ctp file, parsed in Python: (kmer strings,
    orientation 0/1, junction strings)."""
    import gzip
    lines = gzip.open(path, "rt").read().split("\n")
    i = lines.index("}") + 1        # the pretty-printed header's end
    kmers, ors, juncs = [], [], []
    left, kmer = 0, None
    for line in lines[i:]:
        if not line or line[0] == "#":
            continue
        parts = line.split()
        if left == 0:
            kmer, left = parts[0], int(parts[1])
            continue
        kmers.append(kmer)
        ors.append(0 if parts[0] == "F" else 1)
        juncs.append(parts[3])
        left -= 1
    return kmers, np.array(ors, np.uint8), juncs


def check_link_walks(path: str, keys: np.ndarray, edges: np.ndarray, k: int,
                     n: int = 1000, max_steps: int = 100_000) -> dict:
    """n links of the file drawn with a fixed seed, each walked in numpy
    from its kmer in its orientation along the graph's edge bytes: at a
    fork the link's next junction base must be an existing out-edge, and
    the walk must use every junction before it reaches a dead end
    (independent of the port).  Returns counts."""
    kmers, ors, juncs = parse_ctp_links(path)
    if not kmers:
        fail(f"{path}: no links")
    pick = np.random.default_rng(9).choice(len(kmers), min(n, len(kmers)),
                                           replace=False)
    codes = [codes_of(kmers[i].encode()) for i in pick]
    key = np.array([sum(int(c) << (2 * (k - 1 - j)) for j, c in
                        enumerate(cs)) for cs in codes], np.uint64)
    o = ors[pick].astype(bool)
    okm = np.where(o, revcomp_np(key, k), key)
    row, found = rows_of(keys, key)
    if not found.all():
        fail("a link's kmer is not in the graph")
    nj = np.array([len(juncs[i]) for i in pick])
    J = np.zeros((len(pick), nj.max()), np.uint8)
    for r, i in enumerate(pick):
        J[r, :nj[r]] = codes_of(juncs[i].encode())
    ar = np.arange(len(pick))
    pos = np.zeros(len(pick), np.int64)
    ok = np.ones(len(pick), bool)
    mask = np.uint64((1 << 2 * k) - 1)
    pop = np.array([bin(x).count("1") for x in range(16)])
    low = np.array([0, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0])
    steps = 0
    for steps in range(max_steps):
        live = ok & (pos < nj)
        if not live.any():
            break
        nib = (edges[row, 0] >> (4 * o).astype(np.uint8)) & 15
        cnt = pop[nib]
        fork = live & (cnt > 1)
        jb = J[ar, np.minimum(pos, J.shape[1] - 1)]
        ok &= ~(live & (cnt == 0))                        # dead end
        ok &= ~(fork & (((nib >> jb) & 1) == 0))          # no such branch
        adv = live & ok
        base = np.where(fork, jb, low[nib]).astype(np.uint64)
        nxt = ((okm << np.uint64(2)) | base) & mask
        canon = np.minimum(nxt, revcomp_np(nxt, k))
        r2, f2 = rows_of(keys, canon)
        ok &= ~(adv & ~f2)
        adv &= f2
        okm = np.where(adv, nxt, okm)
        row = np.where(adv, r2, row)
        o = np.where(adv, nxt != canon, o)
        pos += adv & fork
    bad = ~(ok & (pos >= nj))
    if bad.any():
        fail(f"{int(bad.sum())} of {len(pick)} links are not walkable in "
             f"numpy (first: {kmers[pick[np.argmax(bad)]]} "
             f"{'FR'[ors[pick[np.argmax(bad)]]]} "
             f"{juncs[pick[np.argmax(bad)]]})")
    return dict(n=len(pick), links=len(kmers), junctions=int(nj.sum()),
                steps=steps)


def thread_counts(log: str) -> tuple:
    m = re.search(r"threaded (\d+) reads \+ 0 pairs -> (\d+) links", log)
    if not m:
        fail("thread printed no 'threaded N reads' line")
    return int(m.group(1)), int(m.group(2))


def gap_counts(log: str) -> str:
    m = re.search(r"\[CorrectAln\] (.*)", log)
    return m.group(1) if m else "no gaps"


N_GAP_READS = 32_768      # phase 4e's reads through gap-filled thread (a
                          # quarter of scale_test.py's 131,072, for the time
                          # limit once the calling phases came in)


def phase_links(torch, tmp, card, genome, reads, fq, linkless_n50) -> int:
    """4e: links on the cleaned E. coli graph of phase 4b, through the CLI
    on the card: thread --no-gap-fill over all the reads, thread with gap
    filling over the first N_GAP_READS, check -p of both, contigs -p with
    the first's links from 512 random seeds; assemble_contigs_primed of 256
    seeds at max_len 200,000 with the gap-filled links, cold and warm; a
    gap-fill batch and a contigs -p batch under torch.profiler.  Returns
    the lookup kernel's launches."""
    from mccortex_tpu_torch.align import correct as acorrect
    from mccortex_tpu_torch.graph import store as gstore
    from mccortex_tpu_torch.io import ctp
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.links import walk as lwalk

    cln = os.path.join(tmp, "clean.ctx")
    h, keys, covg, edges = ctxio.read_ctx(cln)
    kv = keys[:, 0]
    lookups = 0
    all_ctp = os.path.join(tmp, "links_all.ctp.gz")
    gap_ctp = os.path.join(tmp, "links_gap.ctp.gz")
    fq_gap = os.path.join(tmp, "reads_gap.fq")
    write_fastq(fq_gap, reads[:N_GAP_READS])
    for label, argv, out in (
            ("thread --no-gap-fill", ["--no-gap-fill", "--seq", fq], all_ctp),
            ("thread", ["--seq", fq_gap], gap_ctp)):
        with StepCounter(lwalk) as sc:
            log, wall, nl = lookups_of(["thread"] + argv + ["-o", out, cln],
                                       label)
        lookups += nl
        nreads, nlinks = thread_counts(log)
        print(f"links on {card}: mctx-torch {label} of {nreads} reads over "
              f"the {len(kv)}-kmer cleaned graph: wall {wall:.3f}s "
              f"({nreads / wall:.0f} reads/s), {nlinks} links written, "
              f"{sc.steps} linked walker steps; gap fill: "
              f"{gap_counts(log)}; lookup launches {nl}; split: "
              f"{time_split(log)}")
        if nlinks <= 0:
            fail(f"{label} wrote no links")
    for out in (all_ctp, gap_ctp):
        log, wall, nl = lookups_of(["check", "-p", out, cln], "check -p")
        lookups += nl
        m = re.search(r"links OK \((\d+) links, (\d+) colour-walks", log)
        if not m:
            fail(f"check -p {out} did not report its links OK")
        walks = check_link_walks(out, kv, edges, K_MAIN)
        print(f"links: mctx-torch check -p {os.path.basename(out)}: wall "
              f"{wall:.3f}s, {m.group(1)} links, {m.group(2)} colour-walks "
              f"verified, 0 bad; lookup launches {nl}; numpy: {walks['n']} "
              f"of {walks['links']} links drawn walk every one of their "
              f"{walks['junctions']} junctions along existing edges "
              f"({walks['steps']} steps)")

    fa = os.path.join(tmp, "contigs_linked.fa")
    with StepCounter(lwalk) as sc:
        log, wall, nl = lookups_of(
            ["contigs", "-p", all_ctp, "-N", "512", "--batch", "512",
             "--max-len", "65536", "--no-reseed", "-o", fa, cln],
            "contigs -p")
    lookups += nl
    st = check_contigs(read_fasta_seqs(fa), kv, genome, K_MAIN,
                       "mctx-torch contigs -p")
    halts = re.search(r"contigs halt reasons: (.*)", log)
    if not halts:
        fail("contigs -p printed no halt-reason line")
    print(f"links: mctx-torch contigs -p -N 512 of the cleaned graph "
          f"(--batch 512, --max-len 65536, --no-reseed) wall {wall:.3f}s; "
          f"{sc.batches} batches walked, {sc.steps} linked walker steps, "
          f"{st['n']} contigs; total {st['total']} bp, max {st['max']}, "
          f"N50 {st['n50']} (linkless over the whole graph N50 "
          f"{linkless_n50}); dropped pickups "
          f"{sc.drops}; lookup launches {nl}; halt reasons: "
          f"{halts.group(1)}; split: {time_split(log)}")

    g = gstore.from_host(keys, covg, edges, K_MAIN, "cuda")
    gap_links = ctp.load_link_store([gap_ctp], g)
    seeds = np.random.default_rng(0).integers(0, len(kv), 256)
    walls = []
    for turn in ("cold", "warm"):
        with StepCounter(lwalk) as sc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            contigs, stops = lwalk.assemble_contigs_primed(
                g, gap_links, seeds, colour=0, max_len=200_000,
                missing_check=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    st = check_contigs([c.encode() for c in contigs], kv, genome, K_MAIN,
                       "assemble_contigs_primed")
    print(f"assemble_contigs_primed, 256 seeds, max_len 200000, gap-filled "
          f"links: cold {walls[0]:.3f}s (adjacency, hop info and layout "
          f"included), warm {walls[1]:.3f}s; {sc.steps} steps; max "
          f"{st['max']}, N50 {st['n50']}; the longest is a genome "
          f"substring; halts {np.bincount(stops.reshape(-1), minlength=13)}")

    # one gap-fill batch (2048 reads, no links, as thread's default) and
    # one contigs -p batch (128 seeds, max_len 8192) under torch.profiler,
    # caches warm
    batch = reads[:2048]
    all_links = ctp.load_link_store([all_ctp], g)
    for label, fn, warm in (
            ("gap-fill batch of 2048 reads",
             lambda: acorrect.correct_batch(g, None, batch),
             lambda: acorrect.correct_batch(g, None, batch[:64])),
            ("contigs -p batch of 128 seeds",
             lambda: lwalk.assemble_contigs_primed(
                 g, all_links, np.arange(128), colour=0, max_len=8192,
                 missing_check=True),
             lambda: lwalk.get_hopinfo(g, all_links))):
        warm()
        with StepCounter(lwalk) as sc:
            kinds, us, pwall = device_profile(torch, fn)
        ops = sum(kinds.values())
        dev_s = sum(us.values()) / 1e6
        if ops == 0 or sc.steps == 0:
            fail(f"torch.profiler saw no device operation of the {label}")
        print(f"linked walker, one {label} under torch.profiler: "
              f"{sc.steps} walker steps, {ops} device operations "
              f"({json.dumps(kinds)}), {ops / sc.steps:.1f} per step; device "
              f"time {1e3 * dev_s:.3f} ms, busy {100 * dev_s / pwall:.1f}% of "
              f"its wall under the profiler ({pwall:.4f}s)")
    del g, gap_links, all_links
    return lookups


def pe_library(genome: np.ndarray, n: int, seed: int, rlen: int = 150,
               flen=(400, 500), err: float = 0.003):
    """A paired-end library of the genome made as an Illumina library is:
    n fragments of flen bp drawn with numpy from a fixed seed, mate 1 the
    first rlen bp of each, mate 2 the reverse complement of its last rlen
    bp, both with substitutions at rate err.  Returns (mate1, mate2,
    fragment starts, fragment lengths)."""
    rng = np.random.default_rng(seed)
    fl = rng.integers(flen[0], flen[1] + 1, n)
    fs = rng.integers(0, len(genome) - flen[1], n)
    m1 = genome[fs[:, None] + np.arange(rlen)]
    m2 = 3 - genome[(fs + fl)[:, None] - 1 - np.arange(rlen)]
    for m in (m1, m2):
        nerr = int(err * m.size)
        m[rng.integers(0, n, nerr), rng.integers(0, rlen, nerr)] = \
            rng.integers(0, 4, nerr, dtype=np.uint8)
    return m1, m2, fs, fl


def pe_truth(genome: np.ndarray, fs: np.ndarray, fl: np.ndarray,
             rlen: int = 150):
    """The error-free mates of pe_library's fragments."""
    return (genome[fs[:, None] + np.arange(rlen)],
            3 - genome[(fs + fl)[:, None] - 1 - np.arange(rlen)])


def equal_to_truth(seqs: list, truth: np.ndarray) -> int:
    """How many sequences (case ignored) equal their row of truth."""
    n = 0
    for s, t in zip(seqs, truth):
        c = codes_of(s.upper())
        n += len(c) == len(t) and bool((c == t).all())
    return n


def read_threshold_file(path: str) -> dict:
    """A links -T file: sumcovgs=, cutoffs= and suggested_cutoff= lines."""
    out = {}
    for line in open(path).read().splitlines():
        key, val = line.split("=", 1)
        out[key] = [int(x) for x in val.split(",") if x]
    if set(out) != {"sumcovgs", "cutoffs", "suggested_cutoff"} or \
            len(out["suggested_cutoff"]) != 1:
        fail(f"{path} does not parse as a threshold file")
    return out


N_PAIRS = 4_096           # phase 4f's paired-end fragments (4,096 rather
                          # than 32,768 keeps the script in its time limit)
N_SINGLE = 8_192          # phase 4f's single reads through correct -1
N_READS_CMD = 131_072     # phase 4f's reads through `reads` and `reads -v`
FRAG_MAX = 600            # thread/correct -L for its 400-500 bp fragments


def phase_reads_correct(torch, tmp, card, genome, reads, starts) -> int:
    """4f: paired-end links, link cleaning, read correction, read
    filtering and coverage on the cleaned E. coli graph of phase 4b,
    through the CLI on the card, each held to numpy.  Returns the lookup
    kernel's launches."""
    from mccortex_tpu_torch.graph import store as gstore
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.links import thread as lthread
    from mccortex_tpu_torch.links import walk as lwalk

    t_phase = time.perf_counter()
    cln = os.path.join(tmp, "clean.ctx")
    h, keys, covg, edges = ctxio.read_ctx(cln)
    kv = keys[:, 0]
    lookups = 0
    m1, m2, fs, fl = pe_library(genome, N_PAIRS, seed=5)
    t1, t2 = pe_truth(genome, fs, fl)
    r1, r2 = (os.path.join(tmp, f"pe_{i}.fq") for i in (1, 2))
    write_fastq(r1, m1)
    write_fastq(r2, m2)
    print(f"4f: paired-end library of {N_PAIRS} fragments of {fl.min()}-"
          f"{fl.max()} bp, mates of 150 bp ({int((m1 != t1).sum() + (m2 != t2).sum())} "
          f"substitutions); thread/correct -L {FRAG_MAX}")

    # thread -2, gap-filled: links that span each fragment
    pe_ctp = os.path.join(tmp, "links_pe.ctp.gz")
    with StepCounter(lwalk) as sc:
        log, wall, nl = lookups_of(
            ["thread", "-2", r1, r2, "-L", str(FRAG_MAX), "-o", pe_ctp, cln],
            "thread -2")
    lookups += nl
    m = re.search(r"threaded (\d+) reads \+ (\d+) pairs -> (\d+) links", log)
    ins = re.search(r"insert (\d+)/(\d+)", log)
    if not m or int(m.group(2)) != N_PAIRS or int(m.group(3)) <= 0 \
            or not ins:
        fail("thread -2 did not thread every pair into links")
    print(f"4f on {card}: mctx-torch thread -2 of {N_PAIRS} pairs over the "
          f"{len(kv)}-kmer cleaned graph: wall {wall:.3f}s "
          f"({N_PAIRS / wall:.0f} pairs/s), {m.group(3)} links, insert gaps "
          f"bridged {ins.group(1)}/{ins.group(2)}, {sc.steps} linked walker "
          f"steps; gap fill: {gap_counts(log)}; lookup launches {nl}; "
          f"split: {time_split(log)}")
    log, wall, nl = lookups_of(["check", "-p", pe_ctp, cln], "check -p")
    lookups += nl
    mc = re.search(r"links OK \((\d+) links, (\d+) colour-walks", log)
    if not mc:
        fail("check -p of the paired-end links did not report them OK")
    walks = check_link_walks(pe_ctp, kv, edges, K_MAIN)
    print(f"4f: mctx-torch check -p of the paired-end links: wall "
          f"{wall:.3f}s, {mc.group(1)} links, 0 bad; lookup launches {nl}; "
          f"numpy: {walks['n']} of {walks['links']} links drawn walk every "
          f"one of their {walks['junctions']} junctions along existing "
          f"edges ({walks['steps']} steps)")

    # one batch of 2048 pairs under torch.profiler, caches warm
    g = gstore.from_host(keys, covg, edges, K_MAIN, "cuda")

    def pe_batch(n=2048):
        return lthread.thread_reads_pe(
            g, [(m1[:n], m2[:n], 0)], 1, frag_len_max=FRAG_MAX)
    pe_batch(64)
    with StepCounter(lwalk) as sc:
        kinds, us, pwall = device_profile(torch, pe_batch)
    ops = sum(kinds.values())
    dev_s = sum(us.values()) / 1e6
    if ops == 0 or sc.steps == 0:
        fail("torch.profiler saw no device operation of the pair batch")
    print(f"4f: thread_reads_pe, one batch of 2048 pairs under "
          f"torch.profiler: {sc.steps} walker steps, {ops} device "
          f"operations ({json.dumps(kinds)}), {ops / sc.steps:.1f} per step; "
          f"device time {1e3 * dev_s:.3f} ms, busy {100 * dev_s / pwall:.1f}% "
          f"of its wall under the profiler ({pwall:.4f}s)")
    del g

    # links: the trees inspected, then cleaned at the suggested cutoff
    thr, hist, lst = (os.path.join(tmp, f"pe_links.{x}")
                      for x in ("thr", "hist.csv", "list.csv"))
    log, wall, nl = lookups_of(["links", "-T", thr, "-H", hist, "-l", lst,
                                cln, pe_ctp], "links -T -H -l")
    lookups += nl
    sug = read_threshold_file(thr)["suggested_cutoff"][0]
    cut = sug if sug > 1 else 2
    nrows = len(open(lst).read().splitlines()) - 1
    cleaned = os.path.join(tmp, "links_pe_clean.ctp.gz")
    log2, wall2, nl2 = lookups_of(["links", "-c", str(cut), "-o", cleaned,
                                   cln, pe_ctp], "links -c")
    lookups += nl2
    kin, oin, jin = parse_ctp_links(pe_ctp)
    kout, oout, jout = parse_ctp_links(cleaned)
    by_vertex = {}
    for km, o, j in zip(kin, oin.tolist(), jin):
        by_vertex.setdefault((km, o), []).append(j)
    for km, o, j in zip(kout, oout.tolist(), jout):
        if not any(x.startswith(j) for x in by_vertex.get((km, o), ())):
            fail(f"cleaned link {km} {'FR'[o]} {j} is no prefix of an input "
                 "link at its kmer and orientation")
    if len(kout) > len(kin):
        fail(f"links -c raised the links {len(kin)} -> {len(kout)}")
    print(f"4f: mctx-torch links -T -H -l wall {wall:.3f}s (suggested "
          f"cutoff {sug}, {nrows} junction edges listed; split: "
          f"{time_split(log)}), links -c {cut} wall {wall2:.3f}s: "
          f"{len(kin)} -> {len(kout)} links, each a prefix of an input "
          f"link at its kmer and orientation; lookup launches {nl} + {nl2}")

    # correct: single reads and pairs, guided by the paired-end links
    n_se, n_pe = min(N_SINGLE, len(reads)), N_PAIRS // 2
    se_fq = os.path.join(tmp, "se_reads.fq")
    write_fastq(se_fq, reads[:n_se])
    se_truth = np.lib.stride_tricks.sliding_window_view(genome, 150)[
        starts[:n_se]]
    se_out = os.path.join(tmp, "se_fixed.fa")
    log, wall, nl = lookups_of(["correct", "-1", se_fq, "-o", se_out, "-p",
                                pe_ctp, cln], "correct -1")
    lookups += nl
    before = int((reads[:n_se] == se_truth).all(axis=1).sum())
    after = equal_to_truth(read_fasta_seqs(se_out), se_truth)
    print(f"4f: mctx-torch correct -1 of {n_se} reads wall {wall:.3f}s: "
          f"{before} -> {after} reads equal to their genome substring; "
          f"{re.search(r'corrected .*', log).group(0)}; lookup launches {nl};"
          f" split: {time_split(log)}")
    if after <= before:
        fail("correct -1 made no read equal to its genome substring")
    p1, p2 = (os.path.join(tmp, f"pe_half_{i}.fq") for i in (1, 2))
    write_fastq(p1, m1[:n_pe])
    write_fastq(p2, m2[:n_pe])
    pe_out = os.path.join(tmp, "pe_half_fixed.fa")
    log, wall, nl = lookups_of(["correct", "-2", p1, p2, "-o", pe_out, "-L",
                                str(FRAG_MAX), "-p", pe_ctp, cln],
                               "correct -2")
    lookups += nl
    got = read_fasta_seqs(pe_out)
    truth = np.empty((2 * n_pe, 150), np.uint8)
    truth[0::2], truth[1::2] = t1[:n_pe], t2[:n_pe]
    mates = np.empty_like(truth)
    mates[0::2], mates[1::2] = m1[:n_pe], m2[:n_pe]
    before = int((mates == truth).all(axis=1).sum())
    after = equal_to_truth(got, truth)
    print(f"4f: mctx-torch correct -2 of {n_pe} pairs wall {wall:.3f}s: "
          f"{before} -> {after} mates equal to their genome substring; "
          f"{re.search(r'corrected .*', log).group(0)}; "
          f"{gap_counts(log)}; lookup launches {nl}; split: "
          f"{time_split(log)}")
    if after <= before:
        fail("correct -2 made no mate equal to its genome substring")

    # reads: kept and dropped against a numpy membership test
    sub = reads[:N_READS_CMD]
    sub_fq = os.path.join(tmp, "reads_cmd.fq")
    write_fastq(sub_fq, sub)
    nw = sub.shape[1] - K_MAIN + 1
    touch = np.zeros(len(sub), bool)
    for c0 in range(0, len(sub), 65_536):
        ck = canonical_kmers_np(sub[c0:c0 + 65_536], K_MAIN)
        touch[c0:c0 + 65_536] = rows_of(kv, ck)[1].reshape(-1, nw).any(
            axis=1)
    counts = {}
    for inv in (False, True):
        out = os.path.join(tmp, f"reads_kept_{int(inv)}.fa")
        log, wall, nl = lookups_of(["reads", "--seq", sub_fq, "-o", out, cln]
                                   + (["-v"] if inv else []),
                                   "reads" + (" -v" if inv else ""))
        lookups += nl
        mr = re.search(r"kept (\d+)/(\d+) reads", log)
        counts[inv] = (int(mr.group(1)), int(mr.group(2)))
        print(f"4f: mctx-torch reads{' -v' if inv else ''} of {len(sub)} "
              f"reads wall {wall:.3f}s: kept {mr.group(1)}/{mr.group(2)}; "
              f"lookup launches {nl}; split: {time_split(log)}")
    want = int(touch.sum())
    if counts[False] != (want, len(sub)) or \
            counts[True] != (len(sub) - want, len(sub)):
        fail(f"reads kept {counts} against numpy's {want} of {len(sub)}")
    print(f"4f: reads kept {want} and dropped {len(sub) - want} equal the "
          f"numpy membership test; the two sum to {len(sub)}")

    # coverage of 4096 reads against the graph's coverage in numpy
    q_fq = os.path.join(tmp, "reads4k.fq")
    write_fastq(q_fq, reads[:4096])
    cov = os.path.join(tmp, "reads4k.cov")
    log, wall, nl = lookups_of(["coverage", "-1", q_fq, "-e", "-E", "-o", cov,
                                cln], "coverage -e -E")
    lookups += nl
    lines = open(cov).read().split("\n")
    got = np.array([[int(x) for x in lines[4 * i + 1].split()]
                    for i in range(4096)], np.int64)
    ck = canonical_kmers_np(reads[:4096], K_MAIN)
    row, found = rows_of(kv, ck)
    want = np.where(found, covg[row, 0], 0).reshape(4096, nw)
    if not np.array_equal(got, want) or \
            any(len(lines[4 * i + 3]) != nw for i in range(4096)):
        fail("coverage differs from the graph's coverage in numpy")
    print(f"4f: mctx-torch coverage -e -E of 4096 reads wall {wall:.3f}s: "
          f"{got.size} coverages equal the graph's in numpy; lookup "
          f"launches {nl}")
    print(f"4f: phase wall {time.perf_counter() - t_phase:.1f}s; lookup "
          f"launches {lookups}")
    return lookups


def phase_link_cmds(tmp, two, genome):
    """5d: thread (default, --no-gap-fill, -W, -p with -0) of the first
    2048 reads of colour a against the cleaned 2-colour graph of phase 5,
    then contigs -p (-N 64 from a batch of 64 seeds; with -P, from the
    links of 64 reads; with -C -G) and check -p, on the card and on the CPU: the same decompressed
    .ctp text (the date fixed, only the generator masked), the same FASTA
    bytes and status."""
    cln = os.path.join(tmp, "cuda_c.ctx")
    # colour a's reads: thread follows the edges of colour 0, where the
    # links go, so reads of colour b would thread through its SNP kmers
    # into links that are not walkable in colour 0 (the reference's rule)
    fq = os.path.join(tmp, "c0_5d.fq")
    with open(os.path.join(tmp, "c0.fq"), "rb") as src, open(fq, "wb") as dst:
        for _ in range(4 * 2048):
            dst.write(src.readline())
    L = {n: os.path.join(tmp, f"l5_{n}.ctp.gz")
         for n in ("nogap", "default", "small")}
    cases = (  # name, argv with OUT for the output, files it needs
        ("thread --no-gap-fill", ["thread", "--no-gap-fill", "--seq", fq,
                                  "-o", "OUT", cln], L["nogap"]),
        ("thread", ["thread", "--seq", fq, "-o", "OUT", cln], L["default"]),
        ("thread -W", ["thread", "-W", "--seq", fq, "-o", "OUT", cln], None),
        ("thread -p -0", ["thread", "-p", L["nogap"], "-0", "--seq", fq,
                          "-o", "OUT", cln], None),
        ("thread 64 reads", ["thread", "--seq", fq + ".64", "-o", "OUT",
                             cln], L["small"]),
        ("contigs -p", ["contigs", "-p", L["default"], "-N", "64",
                        "--batch", "64", "--max-len", "150", "-o", "OUT",
                        cln], None),
        ("contigs -p -P", ["contigs", "-p", L["small"], "-P", "-N", "64",
                           "--batch", "64", "--max-len", "150", "-o", "OUT",
                           cln], None),
        ("contigs -p -C 0.5 -G 200000",
         ["contigs", "-p", L["default"], "-C", "0.5", "-G", "200000", "-N",
          "64", "--batch", "64", "--max-len", "150", "-o", "OUT", cln],
         None),
        ("check -p", ["check", "-p", L["default"], cln], None))
    with open(fq, "rb") as src, open(fq + ".64", "wb") as dst:
        for _ in range(4 * 64):
            dst.write(src.readline())
    # one output path on both devices: a .ctp header records the
    # command line
    out = os.path.join(tmp, "l5_out")
    for name, argv, keep in cases:
        files, _t, status, wcard, wcpu, launched = same_on_both(
            name, [out if a == "OUT" else a for a in argv],
            [out] if "OUT" in argv else [])
        data = files.get("l5_out", b"")
        if keep:
            os.replace(out, keep)
        extra = ""
        if name.startswith("thread"):
            nreads, nlinks = thread_counts(status)
            extra = f"{nreads} reads -> {nlinks} links; "
        elif name.startswith("contigs"):
            extra = (f"{data.count(b'>')} contigs"
                     f"{', lf.conf headers' if b'lf.conf' in data else ''}"
                     f"{', seeded from unused links' if b'seedpath' in data else ''}; ")
        elif "links OK" not in status:
            fail("check -p did not report the links OK")
        print(f"link command {name} (k={K_MAIN}, 2 colours, cleaned): "
              f"{extra}{len(data)} bytes out, CUDA == CPU; "
              f"wall {wcard:.3f}s on the card (launches "
              f"{json.dumps(launched)}), {wcpu:.3f}s on "
              f"the CPU")


def phase_read_cmds(tmp, genome):
    """5e: thread -2 and -i of 2048 fragments of colour a's genome, links
    -c -l -T -H -P -L on those links, reads -1/-2/-i (and -v) and
    coverage -e -E of phase 5d's 2048 reads and the pairs, and correct
    -1/-2/-i (-F fastq, -W, -p; 512 reads and 256 pairs) on the cleaned
    2-colour graph of phase 5, on the card and on the CPU: the same
    bytes and status."""
    cln = os.path.join(tmp, "cuda_c.ctx")
    se = os.path.join(tmp, "c0_5d.fq")             # phase 5d's reads
    m1, m2, _fs, _fl = pe_library(genome, 2048, seed=7)
    r1, r2, il = (os.path.join(tmp, f"p5_{n}.fq") for n in ("1", "2", "il"))
    write_fastq(r1, m1)
    write_fastq(r2, m2)
    inter = np.empty((2 * len(m1), m1.shape[1]), np.uint8)
    inter[0::2], inter[1::2] = m1, m2
    write_fastq(il, inter)
    # correct takes 512 single reads and 256 pairs (the gap walks of
    # correct and thread -2 are the same code)
    se_few, q1, q2, qi = (os.path.join(tmp, f"p5_{n}.fq")
                          for n in ("se_few", "q1", "q2", "qi"))
    write_fastq(q1, m1[:256])
    write_fastq(q2, m2[:256])
    write_fastq(qi, inter[:512])
    with open(se, "rb") as src, open(se_few, "wb") as dst:
        for _ in range(4 * 512):
            dst.write(src.readline())
    pe = os.path.join(tmp, "p5_links.ctp.gz")
    o = os.path.join(tmp, "p5_out")
    lim = ["-L", str(FRAG_MAX)]
    cases = (
        ("thread -2", ["thread", "-2", r1, r2] + lim + ["-o", o, cln]),
        ("thread -i -W", ["thread", "-i", il, "-W"] + lim
         + ["-o", o, cln]),
        ("links -c -l -T -H -P -L",
         ["links", "-c", "2", "-l", o + ".l", "-T", o + ".t", "-H",
          o + ".h", "-P", o + ".p", "-L", "50", "-o", o, cln, pe]),
        ("reads -1 -2 -i", ["reads", "-1", f"{se}:{o}", "-2",
                            f"{r1}:{r2}:{o}.pe", "-i", f"{il}:{o}.il",
                            cln]),
        ("reads -v", ["reads", "-v", "-F", "fasta", "-1", f"{se}:{o}",
                      "-i", f"{il}:{o}.il", cln]),
        ("coverage -e -E", ["coverage", "-1", se, "-e", "-E", "-o", o,
                            cln]),
        ("correct -1 -2 -i -F fastq -W -p",
         ["correct", "-1", f"{se_few}:{o}", "-2", f"{q1}:{q2}:{o}.pe",
          "-i", f"{qi}:{o}.il", "-F", "fastq", "-W", "-p", pe] + lim
         + [cln]))
    for name, argv in cases:
        files, _t, status, wcard, wcpu, launched = same_on_both(
            name, argv, [o])
        if name == "thread -2":
            os.replace(o, pe)
            m = re.search(r"threaded \d+ reads \+ (\d+) pairs -> (\d+) "
                          r"links", status)
            if not m or int(m.group(1)) != 2048 or int(m.group(2)) <= 0:
                fail("thread -2 did not thread its 2048 pairs into links")
        print(f"read command {name} (k={K_MAIN}, 2 colours, cleaned): "
              f"{len(files)} files, {sum(map(len, files.values()))} "
              f"bytes out, CUDA == CPU; "
              f"{'; '.join(ln[7:] for ln in status.splitlines() if ln.startswith('[mctx] ') and 'memory' not in ln)}; "
              f"wall {wcard:.3f}s on the card (launches "
              f"{json.dumps(launched)}), {wcpu:.3f}s on the CPU")


# ---------------------------------------------------------------------------
# calling: 4g (the E. coli genome), 5f (card == CPU), 5g (pipeline)
# ---------------------------------------------------------------------------

N_SNPS = 500              # phase 4g's planted SNPs and indels of 1-10 bp
N_INDELS = 50             # (2,000 and 200 took the script past 700 s)
VAR_GAP = 300             # every two planted variants at least this apart
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def dna(codes: np.ndarray) -> str:
    return _ACGT[codes].tobytes().decode()


def plant_variants(genome: np.ndarray, seed: int, nsnp: int, nindel: int):
    """(sample genome, [(pos, REF, ALT)] SNPs, the same of indels): SNPs
    and indels of 1-10 bp planted with numpy at multiples of VAR_GAP;
    indels as VCF writes them (pos = the anchor base before them)."""
    rng = np.random.default_rng(seed)
    nvar = nsnp + nindel
    pos = np.sort(rng.choice(np.arange(2, len(genome) // VAR_GAP - 2), nvar,
                             replace=False)) * VAR_GAP
    is_snp = rng.permutation(nvar) < nsnp
    lens = rng.integers(1, 11, nvar)
    is_ins = rng.random(nvar) < 0.5
    ins = rng.integers(0, 4, (nvar, 10), dtype=np.uint8)
    shift = rng.integers(1, 4, nvar).astype(np.uint8)
    parts, last, snps, indels = [], 0, [], []
    for i, p in enumerate(pos.tolist()):
        if is_snp[i]:
            alt = (genome[p] + shift[i]) % 4
            parts += [genome[last:p], np.array([alt], np.uint8)]
            snps.append((p, dna(genome[p:p + 1]), dna(np.array([alt]))))
            last = p + 1
        elif is_ins[i]:
            parts += [genome[last:p + 1], ins[i, :lens[i]]]
            indels.append((p, dna(genome[p:p + 1]),
                           dna(genome[p:p + 1]) + dna(ins[i, :lens[i]])))
            last = p + 1
        else:
            parts.append(genome[last:p + 1])
            indels.append((p, dna(genome[p:p + 1 + lens[i]]),
                           dna(genome[p:p + 1])))
            last = p + 1 + int(lens[i])
    parts.append(genome[last:])
    return np.concatenate(parts), snps, indels


def vcf_rows(path: str) -> list:
    """[(chrom, pos0, REF, ALT, sample fields)] of a VCF."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            out.append((f[0], int(f[1]) - 1, f[3], f[4], f[8:]))
    return out


def check_ref_alleles(rows: list, genome_s: str, label: str):
    """Every record's REF is the genome at its POS."""
    bad = [r for r in rows if genome_s[r[1]:r[1] + len(r[2])] != r[2]]
    if bad:
        fail(f"{label}: {len(bad)} of {len(rows)} records have a REF that is "
             f"not the genome at POS, e.g. {bad[0][:4]}")


def score_calls(rows: list, snps: list, indels: list, outside, k: int):
    """Recall of the planted variants and the false calls, split into SNPs
    and indels.  A SNP is found with its POS/REF/ALT; an indel by a record
    of the same length change within k of it (VCF left-aligns indels in
    repeats).  outside(pos): the variant lies outside the repeat
    families."""
    exact = {(r[1], r[2], r[3]) for r in rows}
    snp_set = set(snps)
    snp_hit = [v in exact for v in snps]
    by_dlen = {}
    for r in rows:
        if len(r[2]) != len(r[3]):
            by_dlen.setdefault(len(r[3]) - len(r[2]), []).append(r[1])
    ind_hit = [any(abs(q - p) <= k for q in by_dlen.get(len(a) - len(rf), ()))
               for p, rf, a in indels]
    ind_pos = {}
    for p, rf, a in indels:
        ind_pos.setdefault(len(a) - len(rf), []).append(p)
    false_snp = sum(1 for r in rows if len(r[2]) == len(r[3])
                    and (r[1], r[2], r[3]) not in snp_set)
    false_ind = sum(1 for r in rows if len(r[2]) != len(r[3]) and not any(
        abs(p - r[1]) <= k for p in ind_pos.get(len(r[3]) - len(r[2]), ())))
    out_snp = [h for h, (p, _r, _a) in zip(snp_hit, snps) if outside(p)]
    return dict(snps=sum(snp_hit), snps_outside=sum(out_snp),
                n_outside=len(out_snp), indels=sum(ind_hit),
                false_snps=false_snp, false_indels=false_ind)


class CallCounter:
    """Counts the bubble caller's forks (calls/bubbles.find_fork_vertices)
    and its walks and walkers (links/walk.walk_linked calls), and keeps
    the arguments of the first walk."""

    def __init__(self, bub, lwalk):
        self.bub, self.lwalk = bub, lwalk
        self.forks = self.walks = self.walkers = 0
        self.first = None
        self._forks, self._walk = bub.find_fork_vertices, lwalk.walk_linked

    def __enter__(self):
        def forks(g):
            out = self._forks(g)
            self.forks += len(out)
            return out

        def walk(g, links, st, *a, **kw):
            self.walks += 1
            self.walkers += st.base.idx.shape[0]
            if self.first is None:
                self.first = (g, links, st, a, kw)
            return self._walk(g, links, st, *a, **kw)

        self.bub.find_fork_vertices, self.lwalk.walk_linked = forks, walk
        return self

    def __exit__(self, *exc):
        self.bub.find_fork_vertices = self._forks
        self.lwalk.walk_linked = self._walk


def phase_calling(torch, tmp, card, genome) -> int:
    """4g: variant calling on the E. coli-sized genome of phase 4, through
    the CLI on the card: 500 SNPs and 50 indels planted in a sample
    (seed 7), its reads (20x of 150 bp, 0.3 % substitutions) built and
    cleaned (`clean -T -U`) as colour 0, the genome built as colour 1,
    the two joined; then `bubbles -H 1`, `calls2vcf`, `breakpoints` and
    its `calls2vcf`, `vcfcov`, `vcfgeno` and `popbubbles` with `check` of
    its graph.  Each command that reads the graph must launch the lookup
    kernel.  Gates: every record's REF is the genome at POS, at least 90 %
    of the SNPs outside the repeat families called with their
    POS/REF/ALT, a ref-only branch in the joined graph at every such SNP,
    at least one bubble popped into a smaller graph that `check` passes.
    Returns the lookup kernel's launches."""
    from mccortex_tpu_torch.calls import bubbles as bub
    from mccortex_tpu_torch.io import ctx as ctxio
    from mccortex_tpu_torch.links import walk as lwalk

    t_phase = time.perf_counter()
    gfa = os.path.join(tmp, "genome.fa")
    genome_s = dna(genome)
    sample, snps, indels = plant_variants(genome, 7, N_SNPS, N_INDELS)
    rep = repeat_mask(len(genome), seed=0)
    rep_k = np.convolve(rep, np.ones(2 * K_MAIN + 1), "same") > 0

    def outside(p):
        return not rep_k[p]

    reads, _starts = reads_of(sample, 20.0, np.random.default_rng(8))
    fq = os.path.join(tmp, "sample.fq")
    write_fastq(fq, reads)
    print(f"4g: sample of {len(sample)} bp with {len(snps)} SNPs and "
          f"{len(indels)} indels of 1-10 bp planted (seed 7, "
          f"{sum(outside(p) for p, _r, _a in snps)} SNPs outside the repeat "
          f"families), {len(reads)} reads x 150 bp, 0.3 % substitutions "
          f"(made in {time.perf_counter() - t_phase:.1f}s)")
    del reads
    paths = {n: os.path.join(tmp, f"call_{n}") for n in (
        "s_raw.ctx", "s.ctx", "ref.ctx", "joint.ctx", "bub.txt.gz",
        "bub.vcf", "brk.txt.gz", "brk.vcf", "cov.vcf", "geno.vcf",
        "popped.ctx")}
    t0 = time.perf_counter()
    for argv in (["build", "-k", str(K_MAIN), "--sample", "sample", "--seq",
                  fq, paths["s_raw.ctx"]],
                 ["clean", "-T", "-U", "-o", paths["s.ctx"],
                  paths["s_raw.ctx"]],
                 ["build", "-k", str(K_MAIN), "--sample", "ref", "--seq", gfa,
                  paths["ref.ctx"]],
                 ["join", "-o", paths["joint.ctx"], paths["s.ctx"],
                  paths["ref.ctx"]]):
        run_cli(argv + ["--device", "cuda"])
    joint = paths["joint.ctx"]
    _h, keys, covg, _e = ctxio.read_ctx(joint)
    kv = keys[:, 0]
    print(f"4g: sample built, cleaned and joined with the reference in "
          f"{time.perf_counter() - t0:.1f}s: {len(kv)} kmers in 2 colours")

    # a ref-only branch at every SNP outside the repeats: the reference
    # kmer centred on it is in colour 1 and not in colour 0
    out_snps = np.array([p for p, _r, _a in snps if outside(p)])
    win = genome[out_snps[:, None] + np.arange(-(K_MAIN // 2),
                                               K_MAIN // 2 + 1)]
    row, found = rows_of(kv, canonical_kmers_np(win, K_MAIN)[:, None])
    row, found = row[:, 0], found[:, 0]
    ref_only = found & (covg[row, 1] > 0) & (covg[row, 0] == 0)
    if not ref_only.all():
        fail(f"4g: {int((~ref_only).sum())} of {len(out_snps)} planted SNPs "
             f"outside the repeats have no ref-only branch in the joined "
             f"graph")

    lookups = 0
    with CallCounter(bub, lwalk) as cc, StepCounter(lwalk) as sc:
        log, wall, nl = lookups_of(["bubbles", "-H", "1", "-o",
                                    paths["bub.txt.gz"], joint], "bubbles")
    lookups += nl
    nbub = int(re.search(r"found (\d+) bubbles", log).group(1))
    print(f"4g on {card}: mctx-torch bubbles -H 1 of the {len(kv)}-kmer "
          f"joined graph: wall {wall:.3f}s, {nbub} bubbles, {cc.forks} "
          f"forks, {cc.walkers} walkers in {cc.walks} walks, {sc.steps} "
          f"walker steps; lookup launches {nl}; split: {time_split(log)}")
    t0 = time.perf_counter()
    log = run_cli(["calls2vcf", "-o", paths["bub.vcf"], paths["bub.txt.gz"],
                   gfa, "--device", "cuda"])
    wall = time.perf_counter() - t0
    rows = vcf_rows(paths["bub.vcf"])
    check_ref_alleles(rows, genome_s, "4g bubbles calls2vcf")
    sc_b = score_calls(rows, snps, indels, outside, K_MAIN)
    print(f"4g: mctx-torch calls2vcf of the bubbles: wall {wall:.3f}s, "
          f"{len(rows)} records, every REF the genome's; SNPs called "
          f"{sc_b['snps']}/{len(snps)} ({sc_b['snps_outside']}/"
          f"{sc_b['n_outside']} outside the repeats), indels "
          f"{sc_b['indels']}/{len(indels)}; false calls: "
          f"{sc_b['false_snps']} SNP-like, {sc_b['false_indels']} indels")
    if sc_b["snps_outside"] < 0.9 * sc_b["n_outside"]:
        fail(f"4g: only {sc_b['snps_outside']} of {sc_b['n_outside']} "
             f"planted SNPs outside the repeats were called")

    # one walk of the bubble caller again, under torch.profiler
    g, links, st, a, kw = cc.first
    with StepCounter(lwalk) as sc:
        kinds, us, pwall = device_profile(
            torch, lambda: lwalk.walk_linked(g, links, st, *a, **kw))
    ops = sum(kinds.values())
    dev_s = sum(us.values()) / 1e6
    if ops == 0 or sc.steps == 0:
        fail("torch.profiler saw no device operation of the bubble walk")
    print(f"4g: the first bubbles walk ({st.base.idx.shape[0]} walkers) "
          f"under torch.profiler: {sc.steps} walker steps, {ops} device "
          f"operations ({json.dumps(kinds)}), {ops / sc.steps:.1f} per step; "
          f"device time {1e3 * dev_s:.3f} ms, busy "
          f"{100 * dev_s / pwall:.1f}% of its wall ({pwall:.4f}s)")
    del g, links, st, cc

    log, wall, nl = lookups_of(["breakpoints", "-s", gfa, "-o",
                                paths["brk.txt.gz"], joint], "breakpoints")
    lookups += nl
    nbrk = int(re.search(r"found (\d+) breakpoints", log).group(1))
    t0 = time.perf_counter()
    run_cli(["calls2vcf", "-o", paths["brk.vcf"], paths["brk.txt.gz"], gfa,
             "--device", "cuda"])
    wall2 = time.perf_counter() - t0
    brows = vcf_rows(paths["brk.vcf"])
    check_ref_alleles(brows, genome_s, "4g breakpoints calls2vcf")
    sc_k = score_calls(brows, snps, indels, outside, K_MAIN)
    print(f"4g: mctx-torch breakpoints -s: wall {wall:.3f}s, {nbrk} calls; "
          f"lookup launches {nl}; split: {time_split(log)}; calls2vcf "
          f"{wall2:.3f}s, {len(brows)} records, every REF the genome's; "
          f"SNPs {sc_k['snps']}/{len(snps)}, indels {sc_k['indels']}/"
          f"{len(indels)}; false calls: {sc_k['false_snps']} SNP-like, "
          f"{sc_k['false_indels']} indels")

    log, wall, nl = lookups_of(["vcfcov", "-r", gfa, "-o", paths["cov.vcf"],
                                paths["bub.vcf"], joint], "vcfcov")
    lookups += nl
    crows = vcf_rows(paths["cov.vcf"])
    tags = [dict(zip(r[4][0].split(":"), r[4][1].split(":"))) for r in crows]
    if len(crows) != len(rows) or any("K31A" not in t for t in tags):
        fail("4g: vcfcov did not annotate every record with K31R/K31A")
    hit = [(r[1], r[2], r[3]) in set(snps) for r in crows]
    alt_cov = [int(t["K31A"]) for t, h in zip(tags, hit)
               if h and t["K31A"] != "."]
    print(f"4g: mctx-torch vcfcov: wall {wall:.3f}s, {len(crows)} records "
          f"annotated; the sample's mean K31A over the called planted SNPs "
          f"{np.mean(alt_cov) if alt_cov else float('nan'):.1f}; lookup "
          f"launches {nl}; split: {time_split(log)}")
    t0 = time.perf_counter()
    run_cli(["vcfgeno", "-k", str(K_MAIN), "--kcov", "20,1", "-o",
             paths["geno.vcf"], paths["cov.vcf"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    gts = {}
    for r, h in zip(vcf_rows(paths["geno.vcf"]), hit):
        if h:
            gt = r[4][1].split(":")[0]
            gts[gt] = gts.get(gt, 0) + 1
    print(f"4g: mctx-torch vcfgeno: wall {wall:.3f}s; the sample's "
          f"genotypes at the called planted SNPs {json.dumps(gts)}")

    log, wall, nl = lookups_of(["popbubbles", "-o", paths["popped.ctx"],
                                joint], "popbubbles")
    lookups += nl
    m = re.search(r"popped (\d+) bubbles: (\d+) -> (\d+) kmers", log)
    if not m or int(m.group(1)) < 1 or int(m.group(3)) >= int(m.group(2)):
        fail("4g: popbubbles popped no bubble or left no smaller graph")
    run_cli(["check", paths["popped.ctx"], "--device", "cuda"])
    _h, pkeys, _c, _e = ctxio.read_ctx(paths["popped.ctx"])
    _r, still = rows_of(pkeys[:, 0], kv[row[ref_only]][:, None])
    print(f"4g: mctx-torch popbubbles: wall {wall:.3f}s, {m.group(1)} "
          f"bubbles popped, {m.group(2)} -> {m.group(3)} kmers, check OK; "
          f"{int((~still).sum())} of {int(ref_only.sum())} ref-only SNP "
          f"kmers popped; lookup launches {nl}; split: {time_split(log)}")
    print(f"4g: phase {time.perf_counter() - t_phase:.1f}s, lookup launches "
          f"{lookups}")
    return lookups


def phase_calling_cmds(tmp, genome):
    """5f: the calling commands on phase 5's 200 kb genome in two colours:
    a sample with 100 SNPs and 10 indels planted (seed 9; reads 15x of
    150 bp, 0.3 % substitutions, built and cleaned) and the genome,
    joined.  On the card and on the CPU: the same call files
    (decompressed, `generator` masked), VCF and BCF bytes and status
    lines.  The commands that read the graph must launch the lookup
    kernel on the card; calls2vcf and vcfgeno read a call file or a VCF
    only."""
    gfa = os.path.join(tmp, "five.fa")
    with open(gfa, "w") as fh:
        fh.write(f">five\n{dna(genome)}\n")
    sample, _snps, _indels = plant_variants(genome, 9, 100, 10)
    reads, _starts = reads_of(sample, 15.0, np.random.default_rng(10))
    fq = os.path.join(tmp, "five_sample.fq")
    write_fastq(fq, reads)
    o = {n: os.path.join(tmp, f"five_{n}") for n in (
        "s_raw.ctx", "s.ctx", "ref.ctx", "joint.ctx", "bub.txt.gz",
        "pop.ctx", "bub.vcf", "bub.bcf", "bub.vcf.gz", "brk.txt.gz",
        "brk.vcf", "cov.vcf", "geno.vcf")}
    for argv in (["build", "-k", str(K_MAIN), "--sample", "sample", "--seq",
                  fq, o["s_raw.ctx"]],
                 ["clean", "-T", "-U", "-o", o["s.ctx"], o["s_raw.ctx"]],
                 ["build", "-k", str(K_MAIN), "--sample", "ref", "--seq", gfa,
                  o["ref.ctx"]],
                 ["join", "-o", o["joint.ctx"], o["s.ctx"], o["ref.ctx"]]):
        run_cli(argv + ["--device", "cuda", "-q"])
    joint = o["joint.ctx"]
    for name, argv, out, need in (
            ("bubbles", ["bubbles", "-o", o["bub.txt.gz"], joint],
             "bub.txt.gz", ("lookup",)),
            ("popbubbles", ["popbubbles", "-o", o["pop.ctx"], joint],
             "pop.ctx", ("lookup",)),
            ("calls2vcf -O vcf", ["calls2vcf", "-O", "vcf", "-o",
                                  o["bub.vcf"], o["bub.txt.gz"], gfa],
             "bub.vcf", ()),
            ("calls2vcf -O bcf", ["calls2vcf", "-O", "bcf", "-o",
                                  o["bub.bcf"], o["bub.txt.gz"], gfa],
             "bub.bcf", ()),
            ("calls2vcf -O vcfgz", ["calls2vcf", "-O", "vcfgz", "-o",
                                    o["bub.vcf.gz"], o["bub.txt.gz"], gfa],
             "bub.vcf.gz", ()),
            ("breakpoints", ["breakpoints", "-s", gfa, "-o", o["brk.txt.gz"],
                             joint], "brk.txt.gz", ("lookup",)),
            ("calls2vcf (breakpoints)", ["calls2vcf", "-o", o["brk.vcf"],
                                         o["brk.txt.gz"], gfa],
             "brk.vcf", ()),
            ("vcfcov", ["vcfcov", "-r", gfa, "-o", o["cov.vcf"], o["bub.vcf"],
                        joint], "cov.vcf", ("lookup",)),
            ("vcfgeno", ["vcfgeno", "-k", str(K_MAIN), "--kcov", "15,1", "-l",
                         "-o", o["geno.vcf"], o["cov.vcf"]], "geno.vcf", ())):
        files, _text, status, wcard, wcpu, launched = same_on_both(
            name, argv, outs=(o[out],), need=need)
        print(f"calling command {name} (k={K_MAIN}, sample + reference): "
              f"{sum(map(len, files.values()))} bytes out, CUDA == CPU; "
              f"{'; '.join(ln[7:] for ln in status.splitlines() if ln.startswith('[mctx] ') and 'memory' not in ln)}; "
              f"wall {wcard:.3f}s on the card (launches "
              f"{json.dumps(launched)}), {wcpu:.3f}s on the CPU")


def _random_dna(n: int, seed: int) -> str:
    """tests/util.py random_dna: n bases from random.Random(seed)."""
    import random
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def phase_pipeline(tmp, card):
    """5g: `mctx-torch pipeline` once on the card, on the 100 kb diploid
    case of tests/test_pipeline_scale.py (its seeded simulation copied:
    SNPs, indels, a tandem repeat, a 400 bp deletion, SE and PE reads);
    it must miss no truth variant, as that test checks."""
    import random
    t_phase = time.perf_counter()
    rng = random.Random(515151)
    k = 31
    G = 100_000
    base = _random_dna(G, seed=4100)
    unit = base[30_000:30_060]
    ref = base[:30_060] + unit + base[30_060:]
    truth = []
    for pp in [2_000, 6_500, 11_000, 17_500, 22_000, 27_000, 36_000, 41_000,
               46_000, 48_500, 55_000, 62_000, 81_000, 92_000]:
        truth.append((pp, ref[pp], "ACGT"[("ACGT".index(ref[pp]) + 1) % 4]))
    for pp, ln in [(8_000, 5), (38_500, 12), (58_000, 3), (86_000, 25)]:
        truth.append((pp, ref[pp:pp + ln + 1], ref[pp]))
    for pp, ln, seed in [(14_000, 6, 4201), (44_000, 10, 4202),
                         (66_000, 18, 4203), (95_000, 4, 4204)]:
        truth.append((pp, ref[pp], ref[pp] + _random_dna(ln, seed=seed)))
    BRK_POS, BRK_LEN = 72_000, 400

    def apply(seq, variants):
        out, last = [], 0
        for pos, r, a in sorted(variants):
            out += [seq[last:pos], a]
            last = pos + len(r)
        return "".join(out + [seq[last:]])

    t_sorted = sorted(truth)
    half = len(t_sorted) // 2
    s1a, s1b = ref, apply(ref, t_sorted[:half] + [t_sorted[half]])
    s2a = s2b = apply(ref, t_sorted[half:] + [
        (BRK_POS, ref[BRK_POS:BRK_POS + BRK_LEN + 1], ref[BRK_POS])])

    def noisy(s):
        out = list(s)
        for i in range(len(out)):
            if rng.random() < 0.003:
                out[i] = rng.choice("ACGT")
        return "".join(out)

    r1 = []
    for _ in range(40 * G // 100):
        hap = s1a if rng.random() < 0.5 else s1b
        pos = rng.randrange(0, len(hap) - 100)
        r1.append(noisy(hap[pos:pos + 100]))
    p1, p2 = [], []
    for _ in range(20 * G // 100):
        hap = s2a if rng.random() < 0.5 else s2b
        ins = 300 + rng.randrange(-30, 31)
        pos = rng.randrange(0, len(hap) - ins)
        frag = hap[pos:pos + ins]
        p1.append(noisy(frag[:100]))
        p2.append(noisy(frag[-100:][::-1].translate(
            str.maketrans("ACGT", "TGCA"))))
    d = os.path.join(tmp, "pipe_in")
    os.makedirs(d, exist_ok=True)
    files = {}
    for name, recs, fmt in (("ref.fa", [ref], ">ref\n{}\n"),
                            ("s1.fa", r1, None), ("s2.1.fa", p1, None),
                            ("s2.2.fa", p2, None)):
        files[name] = os.path.join(d, name)
        with open(files[name], "w") as fh:
            if fmt:
                fh.write(fmt.format(recs[0]))
                continue
            tag = {"s1.fa": "s1_{}", "s2.1.fa": "s2_{}/1",
                   "s2.2.fa": "s2_{}/2"}[name]
            for i, r in enumerate(recs):
                fh.write(f">{tag.format(i)}\n{r}\n")
    samples = os.path.join(d, "samples.txt")
    with open(samples, "w") as fh:
        fh.write(f"s1 {files['s1.fa']} . .\n")
        fh.write(f"s2 . {files['s2.1.fa']}:{files['s2.2.fa']} .\n")
    print(f"5g: 100 kb diploid case of tests/test_pipeline_scale.py: "
          f"{len(r1)} SE reads, {len(p1)} pairs (made in "
          f"{time.perf_counter() - t_phase:.1f}s)")
    from mccortex_tpu_torch.io import vcf as vcfio
    from mccortex_tpu_torch.ops.kernels import _build
    outdir = os.path.join(tmp, "pipe")
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    log = run_cli(["pipeline", "-k", str(k), "--samples", samples, "--ref",
                   files["ref.fa"], "--kcov", "28,28", "-o", outdir,
                   "--device", "cuda"])
    wall = time.perf_counter() - t0
    launched = dict(_build.LAUNCHES)
    if launched.get("lookup", 0) <= 0:
        fail("5g: the pipeline never launched the lookup kernel")
    vcf = vcfio.read_vcf(os.path.join(outdir, "calls.cov.vcf"))
    found = {(r.pos, r.ref, r.alts[0]) for r in vcf.records}
    missed = []
    for (pp, rr, aa) in truth:
        if (pp, rr, aa) in found:
            continue
        dlen = len(aa) - len(rr)
        near = [r for r in vcf.records if abs(r.pos - pp) <= k
                and len(r.alts[0]) - len(r.ref) == dlen]
        if dlen == 0 or not near:
            missed.append((pp, rr[:8], aa[:8]))
    if missed:
        fail(f"5g: the pipeline missed {len(missed)} truth variants: "
             f"{missed}")
    big = [r for r in vcf.records if len(r.ref) - len(r.alts[0])
           >= BRK_LEN - 2 * k and abs(r.pos - BRK_POS) <= 2 * k]
    if not big:
        fail("5g: the 400 bp deletion is not in the pipeline's VCF")
    geno = vcfio.read_vcf(os.path.join(outdir, "calls.geno.vcf"))
    if not geno.records or "GT" not in geno.records[0].fmt or \
            geno.sample_names != ["s1", "s2", "ref"]:
        fail("5g: the genotyped VCF lacks GT or its samples")
    steps = [ln for ln in log.splitlines() if "pipeline: mctx " in ln]
    print(f"5g on {card}: mctx-torch pipeline -k 31 (2 samples + the "
          f"reference, {len(steps)} steps): wall {wall:.3f}s, "
          f"{len(vcf.records)} records, all {len(truth)} truth variants and "
          f"the 400 bp deletion found; launches {json.dumps(launched)}")



def main():
    if not os.path.isdir(os.path.join(HERE, "mccortex_tpu_torch")):
        fail("mccortex_tpu_torch/ is not beside this script: run it from "
             "the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from mccortex_tpu_torch.ops.kernels import _build

    # 1. probe
    print(f"torch {torch.__version__}")
    print(f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)

    # 2. build the kernels
    secs = _build.build()
    print(f"built kernels {', '.join(_build.KERNELS)} in {secs:.1f}s")
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    results = {}
    shapes = phase_kernels(torch, results)
    sorts = phase_sorts(torch, results, shapes)
    del shapes
    torch.cuda.empty_cache()
    phase_lookup(torch, results)
    elapsed("3 kernels")

    with tempfile.TemporaryDirectory() as tmp:
        # 4. the build path at real size, under every sort engine
        by_engine, genome, reads, starts, raw = phase_main_path(torch, tmp,
                                                                card)
        phase_paired(torch, tmp, card, genome, reads)
        elapsed("4 build")
        # 4b. clean and unitigs on its graph
        lookups = phase_graph_path(torch, tmp, card, raw, genome)
        elapsed("4b")
        # 4c. the reference-position index of that graph
        phase_kograph(torch, raw, genome, os.path.join(tmp, "genome.fa"))
        elapsed("4c")
        # 4d. contigs, edge inference and a subgraph of the cleaned graph
        lookups_4d, linkless_n50 = phase_graph_walks(torch, tmp, card,
                                                     genome)
        elapsed("4d")
        # 4e. link threading and linked contigs on the cleaned graph
        lookups_4e = phase_links(torch, tmp, card, genome, reads,
                                 os.path.join(tmp, "reads.fq"), linkless_n50)
        elapsed("4e")
        # 4f. paired-end links, link cleaning, correction, reads, coverage
        lookups_4f = phase_reads_correct(torch, tmp, card, genome, reads,
                                         starts)
        elapsed("4f")
        del reads, starts
        torch.cuda.empty_cache()
        # 4g. variant calling against the genome: bubbles, breakpoints,
        # calls2vcf, vcfcov, vcfgeno, popbubbles
        lookups_4g = phase_calling(torch, tmp, card, genome)
        elapsed("4g")
        del genome
        torch.cuda.empty_cache()
        # 5. CUDA and CPU outputs byte for byte (5f: the calling commands)
        phase_byte_identity(torch, tmp)
        # 5g. the pipeline once on the card
        phase_pipeline(tmp, card)
        elapsed("5g")

    # launches on the main path: the build's kernels from the E. coli build
    # under the default engine, the sort kernels from the build under the
    # engine that runs them, the lookup kernel from clean + unitigs, from
    # contigs + inferedges + subgraph, from thread + check -p +
    # contigs -p, from thread -2, links, correct, reads and coverage and
    # from bubbles, breakpoints, vcfcov and popbubbles
    launches = {"frontend": by_engine["lax"]["frontend"],
                "segreduce": by_engine["lax"]["segreduce"],
                "mergepath": by_engine["lax"]["mergepath"],
                "lookup": (lookups + lookups_4d + lookups_4e + lookups_4f
                           + lookups_4g),
                "mergelevel": by_engine["mp"]["mergelevel"],
                "bitonic_blocksort": by_engine["mp"]["bitonic_blocksort"],
                "bitonic_tail": by_engine["bitonic"]["bitonic_tail"],
                "bitonic_butterfly": by_engine["bitonic"]["bitonic_butterfly"]}
    sources = {"mergelevel": "mergepath", "bitonic_blocksort": "bitonic",
               "bitonic_tail": "bitonic", "bitonic_butterfly": "bitonic"}
    replaces = {
        "frontend": "mccortex_tpu/ops/pallas/frontend.py:203",
        "segreduce": "mccortex_tpu/ops/pallas/segreduce.py:321",
        "mergepath": "mccortex_tpu/ops/pallas/mergepath.py:262",
        "lookup": "mccortex_tpu/ops/pallas/lookup.py:163",
        "mergelevel": "mccortex_tpu/ops/pallas/mergepath.py:190",
        "bitonic_blocksort": "mccortex_tpu/ops/pallas/bitonic.py:106",
        "bitonic_tail": "mccortex_tpu/ops/pallas/bitonic.py:141",
        "bitonic_butterfly": "mccortex_tpu/ops/pallas/bitonic.py:186"}
    # segreduce: one call an epoch (as many as front-end calls) and one a
    # merge (as many as merge-path calls) under lax
    lax = by_engine["lax"]
    results["lookup"].update(launches_clean_unitigs=lookups,
                             launches_graph_walks=lookups_4d,
                             launches_links=lookups_4e,
                             launches_reads_correct=lookups_4f,
                             launches_calling=lookups_4g)
    results["segreduce"].update(launches_epoch=lax["frontend"],
                                launches_merge=lax["segreduce"]
                                - lax["frontend"])
    if lax["segreduce"] - lax["frontend"] != lax["mergepath"]:
        fail(f"segreduce launches {lax['segreduce']} are not one an epoch "
             f"({lax['frontend']}) and one a merge ({lax['mergepath']})")
    kernels = []
    for name in replaces:
        if launches[name] <= 0:
            fail(f"the main path never launched the {name} kernel")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"mccortex_tpu_torch/csrc/{sources.get(name, name)}.cu",
            replaces=replaces[name], launches=launches[name],
            **results[name]))
    print(card)
    print(json.dumps({"sorts": sorts}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

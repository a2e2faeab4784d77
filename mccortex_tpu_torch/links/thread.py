"""Link threading: reads -> link records; counterpart of
mccortex_tpu/links/thread.py (role of ref src/tools/generate_paths.c,
worker_contig_to_junctions :326, _juncs_to_paths :153).

Each read is mapped to its node path (rolling kmers, canonical keys, one
batched store lookup: on a CUDA store the lookup kernel).  Junction and
run-boundary records of the whole batch are compacted on the device in
one pass (torch.nonzero gives the exact count, so there is no record cap
to grow) and cross to the host together; the sequential attach walk
over them is host code copied from the JAX package:

  * at the node just BEFORE each in-junction (indegree > 1), oriented
    along the read, carrying all FORWARD junction choices from that node
    on;
  * at the node just AFTER each out-junction, oriented against the read,
    carrying the reverse-complemented choices of the preceding
    in-junctions, in reverse order.

Gap-filled threading (thread_reads_gapfill) bridges read gaps through
the graph first (align/correct.py) and threads the bridged paths;
paired-end threading (thread_reads_pe) bridges the insert between the
mates of a pair the same way, so its links span whole fragments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import edges as E
from ..graph import store as gstore
from ..ops import hashidx
from ..ops import kmer as kops
from ..utils.timing import span
from . import store as lstore


class ThreadStats:
    """Per-colour corrected-contig length histogram collected while
    threading (role of ref correct_aln_stats.c:81 cap_contig); saved into
    the .ctp header and read back by the contigs confidence model."""

    def __init__(self, ncols: int):
        self.contig_hists = [dict() for _ in range(ncols)]

    def add_contig(self, colour: int, len_bp: int, n: int = 1):
        h = self.contig_hists[colour]
        h[len_bp] = h.get(len_bp, 0) + n

    def add_run_lengths(self, colour: int, lens_bp):
        for x in lens_bp:
            self.add_contig(colour, int(x))


def _record_valid_runs(stats, colour, valid: np.ndarray, k: int):
    """Record the length (bp) of each contiguous valid run of each read."""
    if stats is None:
        return
    v = np.asarray(valid)
    B = v.shape[0]
    pad = np.zeros((B, 1), bool)
    d = np.diff(np.concatenate([pad, v, pad], axis=1).astype(np.int8),
                axis=1)
    starts = np.nonzero(d == 1)
    ends = np.nonzero(d == -1)
    lens = ends[1] - starts[1]
    stats.add_run_lengths(colour, lens + k - 1)


def reads_to_node_paths(g: gstore.DBGraph, bases, k: int):
    """Map reads (B, P) uint8 codes to node paths on g's device: (idx
    int32, orient uint8, valid bool) per position.  A position is valid
    if its kmer window is clean AND present in the graph; idx and orient
    of other positions are unspecified."""
    bases = torch.as_tensor(bases).to(g.device, torch.uint8)
    kmers, valid = kops.rolling_kmers(bases, k)
    keys, orient = kops.canonical(kmers, k)
    idx, found = hashidx.lookup(g.keys, keys)
    return idx.to(torch.int32), orient, valid & found


def _junction_records(g: gstore.DBGraph, idx: torch.Tensor,
                      orient: torch.Tensor, valid: torch.Tensor, k: int,
                      edge_colour: int) -> np.ndarray:
    """Junction and run-boundary records of a batch of node paths, as one
    (6, n) int64 host array in ascending flat order: (pos_flat,
    flags[fw|rv<<1|start<<2|end<<3], fw_base, rv_base, vert_prev,
    vert_next).

    fw junction at i: outdeg > 1 and position i+1 valid; choice base =
    last base of the oriented node at i+1.  rv junction at i: indeg > 1
    and position i-1 valid; raw base = first base of the oriented node at
    i-1 (complemented later) (ref generate_paths.c:351-378)."""
    B, P = idx.shape
    dev = idx.device
    il = idx.long()
    ebyte = g.edges[il, edge_colour]
    outdeg = E.outdegree(ebyte, orient)
    indeg = E.indegree(ebyte, orient)
    fcol = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    nxt_valid = torch.cat([valid[:, 1:], fcol], dim=1)
    prv_valid = torch.cat([fcol, valid[:, :-1]], dim=1)
    is_fw = valid & nxt_valid & (outdeg > 1)
    is_rv = valid & prv_valid & (indeg > 1)
    start = valid & ~prv_valid
    end = valid & ~nxt_valid
    okm = kops.oriented(g.keys[il], orient, k)
    lastb = okm[..., -1] & 3
    firstb = kops.first_base(okm, k).long()
    zcol = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    mcol = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
    fw_base = torch.cat([lastb[:, 1:], zcol], dim=1)
    rv_base = torch.cat([zcol, firstb[:, :-1]], dim=1)
    vert = il * 2 + orient.long()
    vprev = torch.cat([mcol, vert[:, :-1]], dim=1)
    vnext = torch.cat([vert[:, 1:], mcol], dim=1)
    flags = (is_fw.long() | (is_rv.long() << 1) | (start.long() << 2)
             | (end.long() << 3))
    sel = torch.nonzero(flags.reshape(-1) > 0).squeeze(1)
    recs = torch.stack([a.reshape(-1)[sel] for a in
                        (flags, fw_base, rv_base, vprev, vnext)])
    return torch.cat([sel[None], recs]).cpu().numpy()


def thread_contigs(g: gstore.DBGraph, idx, orient, valid, bases,
                   colour: int, edge_colour: int = 0):
    """Raw link records of a batch of node paths: (rows, orients, juncs
    (L, Jmax) u8, nj, colours) numpy arrays ready for
    lstore.build_store.  `bases` is unused (junction bases derive from
    the node path itself, so gap-bridged paths work unchanged)."""
    dev = g.device
    with span("records", dev):
        recs = _junction_records(g, torch.as_tensor(idx).to(dev),
                                 torch.as_tensor(orient).to(dev),
                                 torch.as_tensor(valid).to(dev), g.k,
                                 edge_colour)
    with span("attach"):
        return _records_walk(recs.shape[1], *recs, colour)


def _records_walk(n, pos, flags, fwb, rvb, vprev, vnext, colour):
    """Host walk over the fetched junction records -> raw link-record
    arrays (the sequential tail of thread_contigs)."""
    pos = np.asarray(pos)[:n].tolist()
    flags = np.asarray(flags)[:n].tolist()
    fwb = np.asarray(fwb)[:n].tolist()
    rvb = np.asarray(rvb)[:n].tolist()
    vprev = np.asarray(vprev)[:n].tolist()
    vnext = np.asarray(vnext)[:n].tolist()

    rows_out, orients_out, junc_out, nj_out = [], [], [], []
    i = 0
    while i < n:
        # records of one valid run: start-flag record .. end-flag record
        fw_pos, fw_base, fw_att = [], [], []
        rv_pos, rv_att = [], []
        nuc_rv = []
        j = i
        while True:
            f = flags[j]
            if f & 1:
                fw_pos.append(pos[j])
                fw_base.append(fwb[j])
                fw_att.append(vnext[j])
            if f & 2:
                rv_pos.append(pos[j])
                nuc_rv.append((3 - rvb[j]) & 3)
                rv_att.append(vprev[j])
            if f & 8:
                break
            j += 1
        _emit_run(fw_pos, fw_base, fw_att, rv_pos, nuc_rv, rv_att,
                  rows_out, orients_out, junc_out, nj_out)
        i = j + 1
    L = len(rows_out)
    if L == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, 1), np.uint8), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    Jmax = max(nj_out)
    juncs = np.zeros((L, Jmax), np.uint8)
    for i, jb in enumerate(junc_out):
        juncs[i, :len(jb)] = jb
    return (np.array(rows_out), np.array(orients_out), juncs,
            np.array(nj_out), np.full(L, colour, np.int64))


def _emit_run(fw_pos, fw_base, fw_att, rv_pos, nuc_rv, rv_att,
              rows_out, orients_out, junc_out, nj_out):
    """Sequential link emission (ref _juncs_to_paths) over one valid
    run's junction records.  Positions are flat (row * P + p): within a
    run every comparison is of one row, so flat order works."""
    if not fw_pos or not rv_pos:
        return

    # FW links: for each merge at p (ascending), attach at p-1 along fw.
    # The loop breaks when no fw junction remains at pos >= p; the
    # backtrack also includes a junction exactly at the attach node (ref
    # _juncs_to_paths "backtrack to add the 'F'").
    for pi, p in enumerate(rv_pos):
        js = 0
        while js < len(fw_pos) and fw_pos[js] < p:
            js += 1
        if js == len(fw_pos):
            break
        js -= (js > 0 and fw_pos[js - 1] == p - 1)
        v = rv_att[pi]              # vert at p-1
        rows_out.append(v >> 1)
        orients_out.append(v & 1)
        junc_out.append(fw_base[js:])
        nj_out.append(len(fw_base) - js)

    # RV links: for each fork at q (descending), attach at q+1 against fw
    rv_pos_desc = rv_pos[::-1]
    nuc_rv_desc = nuc_rv[::-1]
    for qi in range(len(fw_pos) - 1, -1, -1):
        q = fw_pos[qi]
        js = 0
        while js < len(rv_pos_desc) and rv_pos_desc[js] > q:
            js += 1
        if js == len(rv_pos_desc):
            break
        js -= (js > 0 and rv_pos_desc[js - 1] == q + 1)
        v = fw_att[qi]              # vert at q+1
        rows_out.append(v >> 1)
        orients_out.append(1 - (v & 1))
        junc_out.append(nuc_rv_desc[js:])
        nj_out.append(len(nuc_rv_desc) - js)


def thread_reads(g: gstore.DBGraph, read_batches, ncols: int,
                 edge_colour: int = 0, stats=None,
                 devices=None) -> lstore.LinkStore:
    """Thread read batches [(bases (B, P) uint8, colour)] through the
    graph and build the deduplicated link store on g's device (ref
    generate_paths.c:499 without gap filling: reads split at missing or
    unclean kmers).

    devices: a list of devices for data-parallel threading (the JAX
    package's _thread_reads_dp): a replica of the store on each, batch i
    threaded on device i mod N, the records collected in batch order, so
    the store is the one-device store."""
    from ..parallel import shard as psh
    devices = devices or [g.device]
    all_recs = []
    for i, (bases, colour) in enumerate(read_batches):
        dev = devices[i % len(devices)]
        with psh.on(dev):
            gd = psh.replica(g, dev)
            with span("paths", dev):
                idx, orient, valid = reads_to_node_paths(gd, bases, g.k)
            if stats is not None:
                _record_valid_runs(stats, colour, valid.cpu().numpy(), g.k)
            recs = thread_contigs(gd, idx, orient, valid, None, colour,
                                  edge_colour)
        if len(recs[0]):
            all_recs.append(recs)
    if not all_recs:
        return lstore.empty(g.capacity, ncols, device=g.device)
    with span("store", g.device):
        return _store_from_recs(g, all_recs, ncols)


def paths_to_rows(paths: list):
    """Bridged vertex paths (-1 = an unbridged base) -> (idx int32,
    orient uint8, valid bool) (B, P2) numpy planes."""
    P2 = max(len(p) for p in paths)
    Bc = len(paths)
    idx = np.zeros((Bc, P2), np.int32)
    orient = np.zeros((Bc, P2), np.uint8)
    valid = np.zeros((Bc, P2), bool)
    for i, p in enumerate(paths):
        ok = p >= 0
        idx[i, :len(p)] = np.where(ok, p >> 1, 0)
        orient[i, :len(p)] = np.where(ok, p & 1, 0)
        valid[i, :len(p)] = ok
    return idx, orient, valid


def _thread_corrected(g, corrected, colour, edge_colour, stats):
    """Link records of a batch of bridged reads (CorrectedRead list), or
    None when it gives none; their path lengths go into stats."""
    paths = [c.verts for c in corrected if len(c.verts)]
    if not paths:
        return None
    if stats is not None:
        stats.add_run_lengths(colour, [len(p) + g.k - 1 for p in paths])
    idx, orient, valid = paths_to_rows(paths)
    recs = thread_contigs(g, torch.from_numpy(idx), torch.from_numpy(orient),
                          torch.from_numpy(valid), None, colour, edge_colour)
    return recs if len(recs[0]) else None


def thread_reads_gapfill(g: gstore.DBGraph, read_batches, ncols: int,
                         links_prev=None, edge_colour: int = 0,
                         stats=None, one_way: bool = True,
                         gap_variance: float = 0.1,
                         gap_wiggle: float = 5,
                         max_context: int | None = None,
                         end_check: bool = True,
                         use_new_paths: bool = False,
                         aln_stats=None):
    """Threading with gap filling: bridge read gaps through the graph
    first (ref generate_paths.c through correct_alignment), then extract
    junctions from the bridged node paths.

    use_new_paths (ref ctx_thread -u, default off): links emitted by
    earlier batches become visible to later batches' gap walkers (batch
    granularity, where the reference's is a read)."""
    from ..align import correct as acorrect
    if max_context is None:
        max_context = acorrect.MAX_CONTEXT
    all_recs = []
    cur_links = links_prev
    for bases, colour in read_batches:
        with span("gapfill", g.device):
            corrected = acorrect.correct_batch(
                g, cur_links, bases, colour=edge_colour, one_way=one_way,
                gap_variance=gap_variance, gap_wiggle=gap_wiggle,
                max_context=max_context, end_check=end_check,
                aln_stats=aln_stats)
        recs = _thread_corrected(g, corrected, colour, edge_colour, stats)
        if recs is not None:
            all_recs.append(recs)
            if use_new_paths:
                built = _store_from_recs(g, all_recs, ncols)
                cur_links = built if links_prev is None else \
                    lstore.merge_stores(links_prev, built, g.capacity)
    if not all_recs:
        return lstore.empty(g.capacity, ncols, device=g.device)
    with span("store", g.device):
        return _store_from_recs(g, all_recs, ncols)


def pair_to_rows(codes1: np.ndarray, codes2: np.ndarray):
    """Lay mate pairs out as r1 + [invalid] + revcomp(r2) rows.  Returns
    (rows (B, L1+1+L2) uint8, mate_col)."""
    B, L1 = codes1.shape
    _, L2 = codes2.shape
    rc2 = np.where(codes2 < 4, 3 - codes2, 4)[:, ::-1]
    rows = np.full((B, L1 + 1 + L2), 4, np.uint8)
    rows[:, :L1] = codes1
    rows[:, L1 + 1:] = rc2
    return rows, L1


def thread_reads_pe(g: gstore.DBGraph, pair_batches, ncols: int,
                    links_prev=None, edge_colour: int = 0,
                    frag_len_min: int = 0, frag_len_max: int = 1000,
                    stats=None, one_way: bool = True,
                    max_context: int | None = None,
                    end_check: bool = True, aln_stats=None):
    """Paired-end threading (ref generate_paths in PE mode): the mates of
    each pair are joined through the graph across the insert gap
    (correct_batch with mate_col), then the junctions of the joined
    paths are extracted, so links span whole fragments."""
    from ..align import correct as acorrect
    if max_context is None:
        max_context = acorrect.MAX_CONTEXT
    all_recs = []
    for codes1, codes2, colour in pair_batches:
        rows, mate_col = pair_to_rows(codes1, codes2)
        with span("gapfill", g.device):
            corrected = acorrect.correct_batch(
                g, links_prev, rows, colour=edge_colour,
                mate_col=mate_col, frag_len_min=frag_len_min,
                frag_len_max=frag_len_max, one_way=one_way,
                max_context=max_context, end_check=end_check,
                aln_stats=aln_stats)
        recs = _thread_corrected(g, corrected, colour, edge_colour, stats)
        if recs is not None:
            all_recs.append(recs)
    if not all_recs:
        return lstore.empty(g.capacity, ncols, device=g.device)
    with span("store", g.device):
        return _store_from_recs(g, all_recs, ncols)


def _store_from_recs(g, all_recs, ncols):
    Jmax = max(r[2].shape[1] for r in all_recs)

    def widen(j):
        out = np.zeros((j.shape[0], Jmax), np.uint8)
        out[:, :j.shape[1]] = j
        return out

    rows = np.concatenate([r[0] for r in all_recs])
    orients = np.concatenate([r[1] for r in all_recs])
    juncs = np.concatenate([widen(r[2]) for r in all_recs])
    njs = np.concatenate([r[3] for r in all_recs])
    cols = np.concatenate([r[4] for r in all_recs])
    return lstore.build_store(g.keys, rows, orients, juncs, njs, cols,
                              ncols)

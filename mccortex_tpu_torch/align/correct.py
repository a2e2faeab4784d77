"""Read-to-graph alignment with gap filling; counterpart of
mccortex_tpu/align/correct.py (role of ref src/alignment/
{db_alignment.c, correct_alignment.c}).

A read is split into runs of graph-present kmers; the sequencing-error
gaps between runs are bridged by walking the graph with links.  Two
modes (ref correct_alignment.c:283-356):

  one-way (default, conservative): walk forward from the left anchor
    until the right anchor is re-acquired; failing that, walk backward
    from the right anchor until the left anchor is re-acquired;
  two-way (liberal): walk from both anchors toward each other with
    alternating single steps, meeting in the middle.

Acceptable bridge lengths (kmers) follow the reference gap model
(correct_alignment.c:403-438): mid-read gaps accept gap_est +/-
(gap_est * GAP_VARIANCE + GAP_WIGGLE); insert (mate) gaps shift the
window by frag_len_{min,max} - sum_read_bases + k - 1.

Every gap of a read batch becomes one batched linked walk on the graph's
device (links/walk.walk_linked, two walkers a gap: left-forward and
right-backward, primed along the read); the acceptance automaton and the
splice run on the host over the recorded paths, copied from the JAX
package.  CorrectAlnStats mirrors ref correct_aln_stats.h:10-27 with its
CSV dumps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import adjacency as adjmod
from ..graph import store as gstore
from ..links import store as lstore
from ..links import thread as lthread
from ..links import walk as lwalk
from ..utils import npkmer
from ..utils.memo import Memo
from ..utils.text import kmers_to_strings
from ..utils.timing import span

GAP_VARIANCE = 0.1   # ref correct_alignment.h:18 DEFAULT_CRTALN_GAP_VARIANCE
GAP_WIGGLE = 5       # ref correct_alignment.h:19 DEFAULT_CRTALN_GAP_WIGGLE
FRAG_LEN_MIN = 0     # ref correct_alignment.h DEFAULT_CRTALN_FRAGLEN_MIN
FRAG_LEN_MAX = 1000  # ref correct_alignment.h:15 DEFAULT_CRTALN_FRAGLEN_MAX
MAX_CONTEXT = 200    # ref correct_alignment.h:21 DEFAULT_CRTALN_MAX_CONTEXT

MAX_GAP_HIST = 128      # ref correct_aln_stats.h:7 ALN_STATS_MAX_GAP
MAX_FRAGLEN_HIST = 1024  # ref correct_aln_stats.h:8 ALN_STATS_MAX_FRAGLEN

_BASE_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def gap_tolerance(n: int) -> int:
    return int(n * GAP_VARIANCE + GAP_WIGGLE)


@dataclasses.dataclass
class CorrectAlnStats:
    """Mirror of ref CorrectAlnStats (correct_aln_stats.h:10-27)."""
    gap_err_histgrm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((MAX_GAP_HIST, MAX_GAP_HIST),
                                         np.int64))
    fraglen_histgrm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(MAX_FRAGLEN_HIST, np.int64))
    contig_histgrm: dict = dataclasses.field(default_factory=dict)
    num_gap_attempts: int = 0
    num_gap_successes: int = 0
    num_paths_disagreed: int = 0   # end-check rejections (use_end_check)
    num_gaps_too_short: int = 0
    num_ins_gaps: int = 0
    num_ins_traversed: int = 0
    num_mid_gaps: int = 0
    num_mid_traversed: int = 0
    num_end_gaps: int = 0          # read-end extension gaps: not traversed
    num_end_traversed: int = 0
    num_missing_edges: int = 0
    num_link_drops: int = 0        # link pickups dropped (bounded slots)

    def update(self, traversed: bool, too_short: bool = False,
               disagreed: bool = False):
        self.num_gap_attempts += 1
        self.num_gap_successes += traversed
        self.num_gaps_too_short += too_short
        self.num_paths_disagreed += disagreed

    def add_gap(self, exp_seq_gap: int, act_gap: int):
        """Sequencing-error gap (ref correct_aln_stats_add)."""
        self.gap_err_histgrm[min(exp_seq_gap, MAX_GAP_HIST - 1),
                             min(act_gap, MAX_GAP_HIST - 1)] += 1

    def add_mp(self, gap_kmers: int, r1bases: int, r2bases: int, k: int):
        """Mate-pair insert gap (ref correct_aln_stats_add_mp):
        fraglen_bp = r1bases + r2bases + gap_kmers - k + 1."""
        fraglen = r1bases + r2bases + gap_kmers - k + 1
        self.fraglen_histgrm[min(max(fraglen, 0),
                                 MAX_FRAGLEN_HIST - 1)] += 1

    def add_contig(self, contig_len_bp: int):
        self.contig_histgrm[contig_len_bp] = \
            self.contig_histgrm.get(contig_len_bp, 0) + 1

    def dump_gaps(self, path: str):
        """Gap size matrix CSV, the byte format of ref
        correct_aln_stats_dump_gaps (correct_aln_stats.c:86)."""
        with open(path, "w") as f:
            f.write(".")
            for j in range(MAX_GAP_HIST):
                f.write(f"\tgraph_{j}")
            f.write("\n")
            for i in range(MAX_GAP_HIST):
                f.write(f"read_{i}")
                for j in range(MAX_GAP_HIST):
                    f.write(f"\t{self.gap_err_histgrm[i, j]}")
                f.write("\n")

    def dump_fraglen(self, path: str):
        """Fragment length CSV (ref correct_aln_stats_dump_fraglen)."""
        with open(path, "w") as f:
            f.write("fraglen_bases\tcount\n")
            for i in range(MAX_FRAGLEN_HIST):
                f.write(f"{i:4d}\t{self.fraglen_histgrm[i]:4d}\n")

    def summary(self) -> str:
        a = max(self.num_gap_attempts, 1)
        return (f"gaps attempted {self.num_gap_attempts}, bridged "
                f"{self.num_gap_successes} "
                f"({100.0 * self.num_gap_successes / a:.1f}%), "
                f"too short {self.num_gaps_too_short}; "
                f"mid {self.num_mid_traversed}/{self.num_mid_gaps}, "
                f"insert {self.num_ins_traversed}/{self.num_ins_gaps}"
                + (f"; end-check rejected {self.num_paths_disagreed}"
                   if self.num_paths_disagreed else "")
                + (f"; link pickups dropped {self.num_link_drops}"
                   if self.num_link_drops else ""))


@dataclasses.dataclass
class CorrectedRead:
    verts: np.ndarray      # bridged node path vertices (2*row+orient)
    seq: str               # corrected sequence (bridged), uppercase
    display: str           # corrected seq with uncorrectable parts lower
    ngaps: int
    nfixed: int


def _two_way_meet(Lp, Rp, gap_max: int):
    """The reference's alternating two-way automaton
    (correct_alignment.c:208-237) replayed over the two recorded walker
    paths.  Lp/Rp: vertex sequences with index 0 = the anchor node (the
    right side's vertices in backward orientation; they meet when
    Lp[i] == Rp[j] ^ 1).  Returns (traversed, gap_len, a0, a1, p0, p1):
    a0/a1 = nodes appended from each side (the meet node by exactly one
    side), p0/p1 = each walker's final index into Lp/Rp."""
    pos = [0, 0]
    app = [0, 0]
    use = [True, True]
    P = [Lp, Rp]
    gap_len = 0
    while gap_len <= gap_max and (use[0] or use[1]):
        for s in (0, 1):
            if not use[s]:
                continue
            if pos[s] + 1 >= len(P[s]):
                use[s] = False
                continue
            pos[s] += 1
            if Lp[pos[0]] == (Rp[pos[1]] ^ 1):
                return (gap_len <= gap_max, gap_len, app[0], app[1],
                        pos[0], pos[1])
            app[s] += 1
            gap_len += 1
    return False, gap_len, app[0], app[1], pos[0], pos[1]


_keys_host_copies = Memo()


def _keys_host(g: gstore.DBGraph) -> np.ndarray:
    """Host copy of g.keys as uint64, memoised on the key tensor: the
    per-gap bookkeeping reads a handful of rows thousands of times."""
    return _keys_host_copies.get(
        (g.keys,), lambda: g.keys.cpu().numpy().view(np.uint64))


def _oriented_np(kk: np.ndarray, ors: np.ndarray, k: int) -> np.ndarray:
    """Kmers (N, W) uint64 read in orientation ors (N,)."""
    return np.where(ors.astype(bool)[:, None], npkmer.revcmp_np(kk, k), kk)


def _verts_bases(g: gstore.DBGraph, verts: np.ndarray, k: int):
    """Last base code of each vertex's oriented kmer (the base each
    bridge node contributes reading left to right), in numpy over the
    cached host keys."""
    if len(verts) == 0:
        return np.zeros(0, np.uint8)
    rows = (verts >> 1).astype(np.int64)
    okm = _oriented_np(_keys_host(g)[rows], verts & 1, k)
    return (okm[:, -1] & np.uint64(3)).astype(np.uint8)


def correct_batch(g: gstore.DBGraph, links: lstore.LinkStore | None,
                  bases: np.ndarray, colour: int | None = 0,
                  ctpcol: int = 0, mate_col: int | None = None,
                  frag_len_min: int = FRAG_LEN_MIN,
                  frag_len_max: int = FRAG_LEN_MAX,
                  one_way: bool = True,
                  gap_variance: float = GAP_VARIANCE,
                  gap_wiggle: float = GAP_WIGGLE,
                  max_context: int = MAX_CONTEXT,
                  end_check: bool = True,
                  aln_stats: CorrectAlnStats | None = None,
                  _return_parts: bool = False):
    """Gap-fill a read batch (B, P) uint8.  Returns list[CorrectedRead]
    (an empty path for reads with no aligned kmer).

    mate_col: rows are mate pairs laid out r1 + [invalid] + revcomp(r2)
    with the break at this column; gaps spanning it are INSERT gaps
    whose window derives from frag_len_min/max (ref
    correct_alignment.c:426-431).  one_way=False is the two-way
    meet-in-the-middle traversal (traverse_two_way2).  aln_stats
    accumulates the gap / fragment histograms and counters."""
    k = g.k
    dev = g.device
    if links is None:
        links = lstore.empty(g.capacity, g.ncols, device=dev)
    if aln_stats is None:
        aln_stats = CorrectAlnStats()
    bases = np.asarray(bases)
    with span("align", dev):
        idx, orient, valid = lthread.reads_to_node_paths(g, bases, k)
        idx = idx.cpu().numpy()
        orient = orient.cpu().numpy()
        valid = valid.cpu().numpy()
    B, P = idx.shape
    sum_bases = (bases < 4).sum(axis=1)

    fills = {}
    with span("gaps"):
        # gaps: (read, left anchor pos, right anchor pos)
        gaps = []
        runs_by_read = []
        for b in range(B):
            v = valid[b]
            starts = np.nonzero(v & ~np.concatenate([[False], v[:-1]]))[0]
            ends = np.nonzero(v & ~np.concatenate([v[1:], [False]]))[0]
            runs = list(zip(starts.tolist(), ends.tolist()))
            runs_by_read.append(runs)
            for ri in range(len(runs) - 1):
                gaps.append((b, runs[ri][1], runs[ri + 1][0]))
        if gaps:
            G = len(gaps)
            gap_bounds = []
            for b, l, r in gaps:
                n = r - l - 1
                is_ins = mate_col is not None and l < mate_col <= r
                if is_ins:
                    ge = max(0, n - k)
                    wig = int(ge * gap_variance + gap_wiggle)
                    adj_min = frag_len_min - int(sum_bases[b]) + k - 1
                    adj_max = frag_len_max - int(sum_bases[b]) + k - 1
                    lo_l = ge - wig + adj_min
                    hi_l = ge + wig + adj_max
                    aln_stats.num_ins_gaps += 1
                else:
                    ge = n
                    wig = int(ge * gap_variance + gap_wiggle)
                    lo_l = ge - wig
                    hi_l = ge + wig
                    aln_stats.num_mid_gaps += 1
                gap_bounds.append((max(0, lo_l), max(0, hi_l), hi_l < 0,
                                   is_ins, ge))
            # context priming (ref graph_walker_prime + traverse): each gap
            # walker starts up to max_context aligned kmers BEFORE its anchor
            # and takes forced steps along the read, picking up links on the
            # way, so in-gap forks that upstream links resolve do not halt it
            end_to_run = {}
            start_to_run = {}
            for b in range(B):
                for (rs, re_) in runs_by_read[b]:
                    end_to_run[(b, re_)] = rs
                    start_to_run[(b, rs)] = re_
            ctxs = []
            for b, l, r in gaps:
                cl = min(l - end_to_run[(b, l)], max_context)
                cr = min(start_to_run[(b, r)] - r, max_context)
                ctxs.append((cl, cr))
            CTX = max(max(cl, cr) for cl, cr in ctxs)

            def _last_bases(b, ps, flip):
                rows = idx[b, ps].astype(np.int64)
                ors = (orient[b, ps] ^ flip).astype(np.uint8)
                return _verts_bases(g, rows * 2 + ors, k)

            forced = np.zeros((2 * G, max(CTX, 1)), np.uint8)
            forced_n = np.zeros(2 * G, np.int32)
            for gi, (b, l, r) in enumerate(gaps):
                cl, cr = ctxs[gi]
                if cl:
                    ps = np.arange(l - cl + 1, l + 1)
                    forced[gi, :cl] = _last_bases(b, ps, 0)
                    forced_n[gi] = cl
                if cr:
                    ps = np.arange(r + cr - 1, r - 1, -1)
                    forced[G + gi, :cr] = _last_bases(b, ps, 1)
                    forced_n[G + gi] = cr

            # end-check margin: after bridging the walk continues freely;
            # those post-anchor choices are compared with the read's aligned
            # nodes (ref graph_walker_agrees_contig via use_end_check)
            ec_win = 32 if end_check else 0
            max_steps = int(min(max(hi for _, hi, _, _, _ in gap_bounds)
                                + 2 + CTX, 4096 + CTX)) + ec_win
            # two walkers a gap: [0:G) left-forward, [G:2G) right-backward
            seed_rows = np.array(
                [idx[b, l - ctxs[gi][0]] for gi, (b, l, _) in enumerate(gaps)]
                + [idx[b, r + ctxs[gi][1]]
                   for gi, (b, _, r) in enumerate(gaps)], np.int32)
            seed_or = np.array(
                [orient[b, l - ctxs[gi][0]]
                 for gi, (b, l, _) in enumerate(gaps)]
                + [orient[b, r + ctxs[gi][1]] ^ 1
                   for gi, (b, _, r) in enumerate(gaps)], np.uint8)
    if gaps:
        adj = adjmod.get_adjacency(g)
        with span("walk", dev):
            st = lwalk.linked_init(g, links, torch.from_numpy(seed_rows),
                                   torch.from_numpy(seed_or), max_steps,
                                   ctpcol=ctpcol)
            st = lwalk.walk_linked(
                g, links, st, colour, max_steps=max_steps, ctpcol=ctpcol,
                adj=adj, forced=torch.from_numpy(forced).to(dev),
                forced_n=torch.from_numpy(forced_n).to(dev))
        aln_stats.num_link_drops += lwalk.report_drops(st, "correct")
    with span("bridge"):
        if gaps:
            # only the columns any walker wrote cross to the host (lengths
            # first, then the power-of-two bucket of columns that covers them)
            wlens = st.base.out_len.cpu().numpy()
            ml = int(wlens.max()) if wlens.size else 1
            Wb = min(1 << max(ml, 1).bit_length(), st.base.out_vert.shape[1])
            wverts = st.base.out_vert[:, :Wb].cpu().numpy()
            for gi, (b, l, r) in enumerate(gaps):
                lo, hi, dead, is_ins, gap_est = gap_bounds[gi]
                if dead:
                    aln_stats.update(False)
                    continue
                cl, cr = ctxs[gi]
                l_anchor = int(idx[b, l]) * 2 + int(orient[b, l])
                r_anchor = int(idx[b, r]) * 2 + int(orient[b, r])
                Lw = wverts[gi, cl:int(wlens[gi])]
                Rw = wverts[G + gi, cr:int(wlens[G + gi])]
                fill_verts = None
                act = 0

                def _exp_fwd(d):
                    # the post-gap aligned nodes r+1..run end: the walker's
                    # continued free output must agree with them (ref
                    # graph_walker_agrees_contig; halting early = agree)
                    re_ = start_to_run[(b, r)]
                    tail = Lw[d + 1:].astype(np.int64)
                    ps = np.arange(r + 1, re_ + 1)
                    exp = idx[b, ps].astype(np.int64) * 2 + orient[b, ps]
                    n = min(len(tail), len(exp))
                    return bool((tail[:n] == exp[:n]).all())

                def _exp_bwd(d):
                    rs = end_to_run[(b, l)]
                    tail = Rw[d + 1:].astype(np.int64)
                    ps = np.arange(l - 1, rs - 1, -1)
                    exp = (idx[b, ps].astype(np.int64) * 2
                           + orient[b, ps]) ^ 1
                    n = min(len(tail), len(exp))
                    return bool((tail[:n] == exp[:n]).all())

                if one_way:
                    # forward: the first re-acquisition of the right anchor
                    hit = np.nonzero(Lw[:hi + 1] == r_anchor)[0]
                    if hit.size:
                        d = int(hit[0])
                        if d < lo:
                            aln_stats.update(False, too_short=True)
                        elif end_check and not _exp_fwd(d):
                            aln_stats.update(False, disagreed=True)
                        else:
                            fill_verts = Lw[:d].astype(np.int64)
                            act = d
                            aln_stats.update(True)
                    else:
                        aln_stats.update(False)
                    if fill_verts is None:
                        # backward: from the right anchor toward the left
                        hit = np.nonzero(Rw[:hi + 1] == (l_anchor ^ 1))[0]
                        if hit.size:
                            d = int(hit[0])
                            if d < lo:
                                aln_stats.update(False, too_short=True)
                            elif end_check and not _exp_bwd(d):
                                aln_stats.update(False, disagreed=True)
                            else:
                                fill_verts = (Rw[:d].astype(np.int64)
                                              ^ 1)[::-1]
                                act = d
                                aln_stats.update(True)
                        else:
                            aln_stats.update(False)
                else:
                    Lp = np.concatenate([[l_anchor], Lw.astype(np.int64)])
                    Rp = np.concatenate([[r_anchor ^ 1], Rw.astype(np.int64)])
                    trav, gap_len, a0, a1, p0, p1 = _two_way_meet(Lp, Rp, hi)
                    rejected = False
                    if trav and end_check:
                        # ref traverse_two_way2 do_paths_check: each walker's
                        # continued output must agree with the other side's
                        # remaining path (and the rhs block for walker 0;
                        # halting early = agree)
                        re_ = start_to_run[(b, r)]
                        ps = np.arange(r + 1, re_ + 1)
                        post = (idx[b, ps].astype(np.int64) * 2
                                + orient[b, ps])
                        exp_f = np.concatenate(
                            [(Rp[np.arange(p1 - 1, -1, -1)] ^ 1), post])
                        tail_f = Lp[p0 + 1:]
                        nf = min(len(tail_f), len(exp_f))
                        rs = end_to_run[(b, l)]
                        qs = np.arange(l - 1, rs - 1, -1)
                        exp_b = np.concatenate(
                            [(Lp[np.arange(p0 - 1, -1, -1)] ^ 1),
                             (idx[b, qs].astype(np.int64) * 2
                              + orient[b, qs]) ^ 1])
                        tail_b = Rp[p1 + 1:]
                        nb = min(len(tail_b), len(exp_b))
                        rejected = not ((tail_f[:nf] == exp_f[:nf]).all()
                                        and (tail_b[:nb] == exp_b[:nb]).all())
                    if rejected:
                        aln_stats.update(False, disagreed=True)
                    elif trav and gap_len >= lo:
                        fill_verts = np.concatenate(
                            [Lp[1:1 + a0], (Rp[1:1 + a1] ^ 1)[::-1]])
                        act = gap_len
                        aln_stats.update(True)
                    else:
                        aln_stats.update(False,
                                         too_short=trav and gap_len < lo)
                if fill_verts is not None:
                    if is_ins:
                        aln_stats.num_ins_traversed += 1
                        aln_stats.add_mp(act, int(sum_bases[b]), 0, k)
                    else:
                        aln_stats.num_mid_traversed += 1
                        aln_stats.add_gap(gap_est, act)
                    fills[(b, l)] = (fill_verts,
                                     _verts_bases(g, fill_verts, k))

        # splice a read at a time (the base extraction is vectorised; the
        # per-read run bookkeeping is short)
        okm_all = _oriented_np(_keys_host(g)[idx.reshape(-1)],
                               orient.reshape(-1), k)
        lastb = _BASE_CHARS[(okm_all[:, -1] & np.uint64(3)).astype(np.int64)
                            ].reshape(B, P)
        if not _return_parts:
            out = [_splice_read(g, k, bases[b], runs_by_read[b], fills,
                                idx, orient, lastb, okm_all, b, P,
                                aln_stats) for b in range(B)]
    if _return_parts:
        return idx, orient, runs_by_read, fills, lastb, okm_all, P
    return out


def _splice_read(g, k, bases_row, runs, fills, idx, orient, lastb,
                 okm_all, b, P, aln_stats, p_lo=0, p_hi=None,
                 col_lo=0, col_hi=None):
    """The corrected sequence and display of kmer positions [p_lo, p_hi)
    and base columns [col_lo, col_hi) of row b (by default the whole
    row).  lastb: (B, P) uint8 character codes of each position's last
    base."""
    if p_hi is None:
        p_hi = P
    if col_hi is None:
        col_hi = len(bases_row)
    runs = [(max(s, p_lo), min(e, p_hi - 1)) for s, e in runs
            if e >= p_lo and s < p_hi]
    if not runs:
        raw = _codes_to_str(bases_row[col_lo:col_hi])
        return CorrectedRead(np.zeros(0, np.int64), raw, raw.lower(),
                             0, 0)
    verts_out = []
    seq_parts = []
    disp_parts = []
    ngaps = nfixed = 0
    s0 = runs[0][0]
    lead = _codes_to_str(bases_row[col_lo:s0])
    first_kmer = kmers_to_strings(okm_all[b * P + s0][None], k)[0]
    seq_parts.append(first_kmer)
    disp_parts.append(lead.lower() + first_kmer)
    verts_out.append([idx[b, s0] * 2 + orient[b, s0]])
    for ri, (s, e) in enumerate(runs):
        if ri > 0:
            ngaps += 1
            fill = fills.get((b, runs[ri - 1][1]))
            if fill is not None:
                nfixed += 1
                fv, fb = fill
                fseq = _BASE_CHARS[fb].tobytes().decode()
                seq_parts.append(fseq)
                disp_parts.append(fseq)
                verts_out.append(fv.tolist())
            else:
                gap_seq = _codes_to_str(
                    bases_row[runs[ri - 1][1] + k: s + k - 1])
                seq_parts.append(gap_seq)
                disp_parts.append(gap_seq.lower())
                verts_out.append([-1] * len(gap_seq))
        lo = s + 1 if ri == 0 else s
        # a fill ends just before the right anchor, which the run includes
        rb = lastb[b, lo:e + 1].tobytes().decode()
        verts_out.append((idx[b, lo:e + 1].astype(np.int64) * 2
                          + orient[b, lo:e + 1]).tolist())
        seq_parts.append(rb)
        disp_parts.append(rb)
    e_last = runs[-1][1]
    disp_parts.append(_codes_to_str(bases_row[e_last + k:col_hi]).lower())
    seq = "".join(seq_parts)
    disp = "".join(disp_parts)
    verts = np.array([v for sub in verts_out for v in sub], np.int64)
    aln_stats.add_contig(len(seq))
    return CorrectedRead(verts, seq, disp, ngaps, nfixed)


def correct_pairs(g: gstore.DBGraph, links, codes1: np.ndarray,
                  codes2: np.ndarray, colour: int | None = 0,
                  frag_len_min: int = FRAG_LEN_MIN,
                  frag_len_max: int = FRAG_LEN_MAX,
                  one_way: bool = True,
                  max_context: int = MAX_CONTEXT,
                  end_check: bool = True,
                  aln_stats: CorrectAlnStats | None = None):
    """Paired-end correction (ref ctx_correct --seq2): the mates are laid
    out as one fragment row (r1 + a break + revcomp(r2)) so that gap
    bridging uses the pair's context across the insert, then each mate's
    corrected sequence is spliced out of its own half (the insert bridge
    anchors but is not emitted).  Returns (mates1, mates2), mate 2 in
    its own (reverse-strand) orientation again."""
    from ..utils.dna import revcomp
    rows, mate_col = lthread.pair_to_rows(codes1, codes2)
    if aln_stats is None:
        aln_stats = CorrectAlnStats()
    res = correct_batch(g, links, rows, colour=colour,
                        mate_col=mate_col, frag_len_min=frag_len_min,
                        frag_len_max=frag_len_max, one_way=one_way,
                        max_context=max_context, end_check=end_check,
                        aln_stats=aln_stats, _return_parts=True)
    idx, orient, runs_by_read, fills, lastb, okm_all, P = res
    k = g.k
    out1, out2 = [], []
    for b in range(rows.shape[0]):
        runs = runs_by_read[b]
        r1 = _splice_read(g, k, rows[b], runs, fills, idx, orient,
                          lastb, okm_all, b, P, aln_stats,
                          p_lo=0, p_hi=mate_col - k + 1,
                          col_lo=0, col_hi=mate_col)
        r2f = _splice_read(g, k, rows[b], runs, fills, idx, orient,
                           lastb, okm_all, b, P, aln_stats,
                           p_lo=mate_col + 1, p_hi=P,
                           col_lo=mate_col + 1, col_hi=len(rows[b]))
        out1.append(r1)
        # mate 2 was reverse-complemented into the row: restore it
        v2 = r2f.verts[::-1].copy()
        v2[v2 >= 0] ^= 1
        out2.append(CorrectedRead(
            verts=v2, seq=revcomp(r2f.seq),
            display=_rc_display(r2f.display),
            ngaps=r2f.ngaps, nfixed=r2f.nfixed))
    return out1, out2


def _rc_display(disp: str) -> str:
    """Reverse-complement a display string, keeping each base's case."""
    from ..utils.dna import revcomp
    rc = revcomp(disp.upper())
    cases = [c.islower() for c in disp][::-1]
    return "".join(ch.lower() if lo else ch
                   for ch, lo in zip(rc, cases))


def _codes_to_str(codes) -> str:
    return _BASE_CHARS[np.minimum(np.asarray(codes, np.int64), 4)
                       ].tobytes().decode()

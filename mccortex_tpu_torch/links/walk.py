"""Link-aware batched traversal; counterpart of mccortex_tpu/links/walk.py.

Extends graph/traverse.py with link-cursor state, mirroring the
reference walker (ref graph_walker.c):

  * links are picked up at every node whose vertex has links in the walk
    link colour (pickup_paths :151), cursor age 0;
  * cursor ages increase when the walk passes a segment boundary: an
    out-fork the links resolved or an in-merge (_gw_gseg_update
    :105-131);
  * at an in-colour fork the cursors of greatest age vote: age >= 1 and
    all of them agree (choose :452-476), else the walk halts with
    NOLINKS / SPLIT_LINKS;
  * on a resolved fork every cursor whose current base differs from the
    taken base dies; matching cursors consume one base
    (_graph_walker_force_jump :556-585).

Cursors live in fixed slot arrays (CMAX slots a walker); pickups beyond
them are counted as dropped.  Brent cycle detection hashes (node,
cursor multiset), so a repeat is cut only when the whole walker state
repeats.

Where the JAX package runs the step under `lax.while_loop` (walk_linked,
_fetch_links) or `lax.fori_loop` (walk_along), this module runs the same
step in a host loop and reads the loop condition once a step, so it
leaves on the same step.  The per-slot pickup loops of the JAX step are
one vectorised update here (slot s of a walker takes its s-th free slot
in both).  Writes the JAX package drops with `mode="drop"` go to one
spare column or slot, sliced off.  uint64 hashes are int64 bit views.

On a card, a walk with the adjacency and without hops, the confidence
model, the missing-information check or used-link marks (the gap
filler's) runs in one launch of the walk kernel (csrc/walk.cu, a warp a
walker, every step inside the kernel); every other walk, and every walk
on the CPU, runs the host loop, which is the kernel's reference.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..graph import adjacency as adjmod
from ..graph import edges as E
from ..graph import store as gstore
from ..graph import traverse as T
from ..ops import kmer as kops
from ..ops import sorted as sops
from ..utils.memo import Memo
from ..utils.text import kmers_to_strings
from ..utils.timing import count, span
from . import store as lstore

CMAX = 64   # cursor slots per walker
CMAX2 = 32  # counter-path slots per walker (missing-info check)
SMAX = 32   # graph-segment window per walker (ref gsegs; age window)
HOP_CAP = 512  # unitig-interior hop records per walker; when full the
               # walk degrades to per-node stepping
PICKUP_CAP = 16   # links examined per node (pickup)
CNTR_CAP = 8      # links examined per predecessor (counter pickup)

# cumulative dropped-pickup counts per walk context
DROP_COUNTS: dict = {}

_CHARS = np.frombuffer(b"ACGT", np.uint8)


def report_drops(st: "LinkedWalkState", context: str) -> int:
    """Warn about link pickups dropped by the bounded cursor slots.
    Returns the drop count of this walk and adds it to
    DROP_COUNTS[context].  The reference keeps unbounded link lists, so
    any drop may change a result and is never silent."""
    nd = int(st.n_drop.sum())
    if nd:
        DROP_COUNTS[context] = DROP_COUNTS.get(context, 0) + nd
        print(f"[mctx] warning: {nd} link pickups dropped during "
              f"{context} (cursor slots full / >16 links per node) — "
              f"results may differ from the unbounded-list reference",
              file=sys.stderr)
    return nd


@dataclasses.dataclass
class LinkedWalkState:
    base: T.WalkState
    cur_link: torch.Tensor   # (B, CMAX) int32, -1 = empty
    cur_pos: torch.Tensor    # (B, CMAX) int32
    cur_age: torch.Tensor    # (B, CMAX) int32
    cntr_link: torch.Tensor  # (B, CMAX2) int32 counter paths
    cntr_pos: torch.Tensor   # (B, CMAX2) int32
    cntr_age: torch.Tensor   # (B, CMAX2) int32
    # graph segments, index 0 = most recent (ref graph_walker.c gsegs; a
    # cursor of age a was picked up in segment a)
    seg_nodes: torch.Tensor  # (B, SMAX) int32 nodes per segment
    seg_infork: torch.Tensor  # (B, SMAX) bool segment began at an in-merge
    # confidence-model accumulators (ref assemble_contigs.c:100-117)
    cum_conf: torch.Tensor   # (B,) float32 product of step confidences
    max_gap: torch.Tensor    # (B,) int32 largest USELINKS gap (bp)
    used: torch.Tensor       # (nlinks,) bool links followed to their end
    n_drop: torch.Tensor     # (B,) int32 dropped pickups
    # unitig-interior hop records: hop_v = entry vertex (the skipped
    # stretch is the next hop_n layout positions after it), hop_off =
    # the out_len offset it occupies (filled by fill_hop_outputs)
    hop_v: torch.Tensor      # (B, HOP_CAP) int32
    hop_n: torch.Tensor      # (B, HOP_CAP) int32
    hop_off: torch.Tensor    # (B, HOP_CAP) int32
    hop_cnt: torch.Tensor    # (B,) int32

    def replace(self, **kw) -> "LinkedWalkState":
        return dataclasses.replace(self, **kw)


def _rbase(b: T.WalkState, **kw) -> T.WalkState:
    return dataclasses.replace(b, **kw)


def linked_init(g: gstore.DBGraph, links: lstore.LinkStore, seed_idx,
                seed_orient, max_len: int, ctpcol: int = 0
                ) -> LinkedWalkState:
    base = T.walk_init(g, seed_idx, seed_orient, max_len)
    B = base.idx.shape[0]
    dev = g.device

    def z(n, dtype=torch.int32, fill=0):
        return torch.full((B, n), fill, dtype=dtype, device=dev)

    seg_nodes = z(SMAX)
    seg_nodes[:, 0] = 1
    zb = torch.zeros((B,), dtype=torch.int32, device=dev)
    st = LinkedWalkState(
        base=base, cur_link=z(CMAX, fill=-1), cur_pos=z(CMAX),
        cur_age=z(CMAX), cntr_link=z(CMAX2, fill=-1), cntr_pos=z(CMAX2),
        cntr_age=z(CMAX2), seg_nodes=seg_nodes,
        seg_infork=z(SMAX, torch.bool, False),
        cum_conf=torch.ones((B,), dtype=torch.float32, device=dev),
        max_gap=zb, used=torch.zeros((max(links.nlinks, 1),),
                                     dtype=torch.bool, device=dev),
        n_drop=zb, hop_v=z(HOP_CAP), hop_n=z(HOP_CAP), hop_off=z(HOP_CAP),
        hop_cnt=zb)
    # links on the seed node itself are picked up at the start
    st = _pickup(links, st, ctpcol)
    return st.replace(base=_rbase(st.base, brent_hash=_linked_hash(st)))


def state_from_numpy(st, device="cuda") -> LinkedWalkState:
    """The port's LinkedWalkState from a state whose fields read as numpy
    arrays (np.asarray of each), e.g. the JAX package's LinkedWalkState:
    uint64 fields become int64 bit views.  A walk can then resume from
    the same mid-walk state in both packages."""
    def t(x):
        a = np.ascontiguousarray(np.asarray(x))
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(device)

    base = T.WalkState(**{f.name: t(getattr(st.base, f.name))
                          for f in dataclasses.fields(T.WalkState)})
    return LinkedWalkState(base=base, **{
        f.name: t(getattr(st, f.name))
        for f in dataclasses.fields(LinkedWalkState) if f.name != "base"})


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of the columns of (B, n) int64 (n a power of two), folded
    pairwise: torch has no XOR reduction, and XOR is associative and
    commutative, so any order gives the JAX package's lax.reduce."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def _linked_hash(st: LinkedWalkState) -> torch.Tensor:
    """Order-independent hash of (node, cursors, counter cursors), bit
    for bit the JAX package's (int64 bit views of its uint64)."""
    h = kops.kmer_hash(st.base.okm)
    for lk, ps, ag in ((st.cur_link, st.cur_pos, st.cur_age),
                       (st.cntr_link, st.cntr_pos, st.cntr_age)):
        ch = kops.splitmix64(lk.long() ^ (ps.long() << 24)
                             ^ (ag.long() << 48))
        ch = torch.where(lk >= 0, ch, 0)
        h = h ^ _xor_fold(ch)
    return h


def _junc_bases(links: lstore.LinkStore, lid: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Junction base at pos of link lid (any shape; lid clipped)."""
    lidc = lid.long().clamp(0, links.nlinks - 1).reshape(-1)
    return lstore.unpack_junc(links.seq[lidc], pos.reshape(-1)).reshape(
        lid.shape)


def _cursor_bases(links: lstore.LinkStore, st: LinkedWalkState):
    """Current junction base per cursor slot: (B, CMAX) uint8."""
    if links.nlinks == 0:
        return torch.zeros(st.cur_link.shape, dtype=torch.uint8,
                           device=st.cur_link.device)
    return _junc_bases(links, st.cur_link, st.cur_pos)


def _cntr_bases(links: lstore.LinkStore, st: LinkedWalkState):
    if links.nlinks == 0:
        return torch.zeros(st.cntr_link.shape, dtype=torch.uint8,
                           device=st.cntr_link.device)
    return _junc_bases(links, st.cntr_link, st.cntr_pos)


def _free_slots(link: torch.Tensor, n: int):
    """(slot (B, n) int64, has_slot (B, n) bool): the s-th free slot of
    each walker's slot array for s < n (free = link < 0)."""
    B, S = link.shape
    dev = link.device
    free = link < 0
    rank = torch.cumsum(free.to(torch.int32), dim=1, dtype=torch.int32) - 1
    col = torch.where(free & (rank < n), rank, n).long()
    slot = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    slot.scatter_(1, col, torch.arange(S, device=dev).expand(B, S))
    nfree = free.sum(dim=1, dtype=torch.int32)
    has = torch.arange(n, device=dev)[None, :] < nfree[:, None]
    return slot[:, :n], has


def _fill_slots(arrays, vals, slot, ok):
    """Write vals[i] into arrays[i] at (walker, slot) where ok; arrays
    are (B, S) and returned new (the writes not taken go to a spare
    column, sliced off)."""
    out = []
    for a, v in zip(arrays, vals):
        S = a.shape[1]
        a2 = T._spare(a, 0)
        a2.scatter_(1, torch.where(ok, slot, S),
                    v.to(a.dtype).expand(slot.shape))
        out.append(a2[:, :S])
    return out


def _pickup(links: lstore.LinkStore, st: LinkedWalkState, ctpcol: int
            ) -> LinkedWalkState:
    """Pick up the links of the current vertex (age 0) into free slots:
    link s of the vertex (s < PICKUP_CAP) takes the walker's s-th free
    slot, if it has one."""
    if links.nlinks == 0:
        return st
    b = st.base
    dev = b.idx.device
    v = b.idx.long() * 2 + b.orient.long()
    start = links.offsets[v].long()
    navail = links.offsets[v + 1].long() - start
    s = torch.arange(PICKUP_CAP, device=dev)[None, :]
    lid = (start[:, None] + s).clamp(0, links.nlinks - 1)
    ok = ((s < navail[:, None]) & b.active[:, None]
          & (links.nseen[lid, ctpcol] != 0))
    slot, has = _free_slots(st.cur_link, PICKUP_CAP)
    # links beyond the per-node cap are never examined: counted dropped
    n_drop = (st.n_drop
              + torch.where(b.active, (navail - PICKUP_CAP).clamp(min=0), 0)
              + (ok & ~has).sum(dim=1)).to(torch.int32)
    ok = ok & has
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    cur_link, cur_pos, cur_age = _fill_slots(
        (st.cur_link, st.cur_pos, st.cur_age), (lid, zero, zero), slot, ok)
    return st.replace(cur_link=cur_link, cur_pos=cur_pos, cur_age=cur_age,
                      n_drop=n_drop)


def _pickup_counter(g, links, st: LinkedWalkState, adv, lost_nuc,
                    ctpcol: int, edge_colour: int, adj):
    """Pick up counter paths at the new node's OTHER predecessors (ref
    graph_walker_add_counter_paths + pickup_paths counter mode)."""
    if links.nlinks == 0:
        return st
    b = st.base
    B = b.idx.shape[0]
    dev = b.idx.device
    il = b.idx.long()
    next_base = b.okm[:, -1] & 3
    rev_o = 1 - b.orient
    rev_okm = None if adj is not None else kops.oriented(g.keys[il], rev_o,
                                                         g.k)
    in_nib = E.with_orientation(g.edges[il, edge_colour], rev_o)
    back_bit = (3 - lost_nuc.long()) & 3
    pop4 = T._table("pop4", E.POPCOUNT4, dev)
    cl, cp, ca = st.cntr_link, st.cntr_pos, st.cntr_age
    cntr_drop = torch.zeros((B,), dtype=torch.int64, device=dev)
    s = torch.arange(CNTR_CAP, device=dev)[None, :]
    vrev = il * 2 + rev_o.long()
    for n in range(4):
        has = (((in_nib >> n) & 1).bool() & (back_bit != n) & adv)
        if adj is not None:
            nv = adjmod.adj_at(adj, vrev, n).long()
            qfound = nv >= 0
            qrow = nv.clamp(min=0) >> 1
            qo = nv.clamp(min=0) & 1
        else:
            pk = kops.shift_append(rev_okm, torch.full(
                (B,), n, dtype=torch.int64, device=dev), g.k)
            qkey, qo8 = kops.canonical(pk, g.k)
            qrow, qfound = sops.lookup(g.keys, qkey)
            qrow, qo = qrow.long(), qo8.long()
        # the predecessor oriented TOWARD the current node
        pv = qrow * 2 + (1 - qo)
        # filter-nuc0 applies when the predecessor forks toward us
        pnib = E.with_orientation(g.edges[qrow, edge_colour], 1 - qo)
        filter0 = pop4[pnib.long()] > 1
        start = links.offsets[pv].long()
        navail = links.offsets[pv + 1].long() - start
        ok_node = has & qfound
        cntr_drop = cntr_drop + torch.where(
            ok_node, (navail - CNTR_CAP).clamp(min=0), 0)
        lid = (start[:, None] + s).clamp(0, links.nlinks - 1)
        base0 = _junc_bases(links, lid, torch.zeros_like(lid))
        nj = links.nj[lid]
        want = (ok_node[:, None] & (s < navail[:, None])
                & (links.nseen[lid, ctpcol] != 0))
        f0 = filter0[:, None]
        want = want & (~f0 | ((base0.long() == next_base[:, None])
                              & (nj > 1)))
        slot, has_slot = _free_slots(cl, CNTR_CAP)
        cntr_drop = cntr_drop + (want & ~has_slot).sum(dim=1)
        want = want & has_slot
        cl, cp, ca = _fill_slots(
            (cl, cp, ca), (lid, f0.to(torch.int32),
                           torch.zeros((), dtype=torch.int32, device=dev)),
            slot, want)
    return st.replace(cntr_link=cl, cntr_pos=cp, cntr_age=ca,
                      n_drop=(st.n_drop + cntr_drop).to(torch.int32))


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 if none), as jnp.argmax of
    a bool row: torch.argmax of int32 also returns the first maximum."""
    return torch.argmax(m.to(torch.int32), dim=1)


def _path_gap(st: LinkedWalkState, live, bases, rep):
    """Distance between deciding junctions (ref graph_walker.c:491-496):
    choice_age = age of the oldest cursor disagreeing with the oldest
    cohort's base (0 if unanimous); the gap is the node count from the
    current position back through the first in-merge segment at age >=
    choice_age."""
    B = bases.shape[0]
    dev = bases.device
    disagree = live & (bases != rep[:, None])
    choice_age = torch.where(disagree, st.cur_age, 0).amax(dim=1)
    sidx = torch.arange(SMAX, device=dev)
    infork_ge = st.seg_infork & (sidx[None, :] >= choice_age[:, None])
    astar = torch.where(infork_ge.any(dim=1), _first_true(infork_ge),
                        SMAX - 1)
    cum = torch.cumsum(st.seg_nodes, dim=1, dtype=torch.int32)
    return cum[torch.arange(B, device=dev), astar]


def _nib_of(bases: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """4-bit mask of the bases held by the live slots of each walker."""
    out = torch.zeros(bases.shape[:1], dtype=torch.uint8,
                      device=bases.device)
    for n in range(4):
        out = out | ((live & (bases == n)).any(dim=1).to(torch.uint8) << n)
    return out


def _choose_linked(links, st: LinkedWalkState, bases, pop_nib, col_nib,
                   missing_check: bool):
    """The full 9-state decision (graph_walker_choose).  bases: the
    cursors' current junction bases."""
    dev = pop_nib.device
    nuc0, go0, status0 = T.choose_linkless(pop_nib, col_nib)
    fork = status0 == T.NOLINKS   # in-colour fork: link logic engages
    live = st.cur_link >= 0
    B = bases.shape[0]
    max_age = torch.where(live, st.cur_age, -1).amax(dim=1)
    has_curs = live.any(dim=1)
    is_oldest = live & (st.cur_age == max_age[:, None])
    rep = bases[torch.arange(B, device=dev), _first_true(is_oldest)]
    split = (is_oldest & (bases != rep[:, None])).any(dim=1)
    cand_ok = ((col_nib >> rep) & 1).bool()
    if missing_check:
        # every in-colour candidate must be covered by some path or
        # counter path (ref graph_walker_choose:497-504)
        taken = _nib_of(bases, live) | _nib_of(_cntr_bases(links, st),
                                               st.cntr_link >= 0)
        pop4 = T._table("pop4", E.POPCOUNT4, dev)
        missing = pop4[(taken & col_nib).long()] < pop4[col_nib.long()]
    else:
        missing = torch.zeros(col_nib.shape, dtype=torch.bool, device=dev)
    no_curs = ~has_curs | (max_age < 1)
    use = fork & ~no_curs & ~split & cand_ok & ~missing
    status = torch.where(
        fork,
        torch.where(no_curs, T.NOLINKS,
                    torch.where(split, T.SPLIT_LINKS,
                                torch.where(missing, T.MISSING_LINKS,
                                            torch.where(cand_ok, T.USELINKS,
                                                        T.SPLIT_LINKS)))),
        status0).to(torch.int32)
    nuc = torch.where(use, rep, nuc0)
    go = torch.where(fork, use, go0)
    return nuc, go, status, _path_gap(st, live, bases, rep)


def _nj_of(links, lk: torch.Tensor) -> torch.Tensor:
    if links.nlinks == 0:
        return torch.ones_like(lk)
    return links.nj[lk.long().clamp(0, links.nlinks - 1)]


def _other_prev_exists(g, b: T.WalkState, lost_nuc, edge_colour):
    """True where the (new) current node has in-colour predecessors other
    than the node we came from (ref db_graph_prev_nodes_with_mask)."""
    in_nib = E.with_orientation(g.edges[b.idx.long(), edge_colour],
                                1 - b.orient.long())
    back_bit = 1 << ((3 - lost_nuc.long()) & 3)
    return (in_nib.long() & ~back_bit) > 0


def _cursor_step(links, st: LinkedWalkState, bases, nuc, adv, is_fork):
    """Cursor advancement on resolved forks: every live cursor whose base
    differs from the taken one, or that is exhausted, dies; matching
    cursors consume one base.  Returns (cur_link, cur_pos, match,
    exhausted, live, move_fork)."""
    move_fork = adv & is_fork
    live = st.cur_link >= 0
    match = bases == nuc[:, None]
    exhausted = st.cur_pos + 1 >= _nj_of(links, st.cur_link)
    mf = move_fork[:, None]
    keep = live & (~mf | (match & ~exhausted))
    cur_pos = torch.where(mf & keep, st.cur_pos + 1, st.cur_pos)
    cur_link = torch.where(keep, st.cur_link, -1)
    return cur_link, cur_pos, match, exhausted, live, move_fork


def _segments(st: LinkedWalkState, bump, rv_fork, adv):
    """Graph-segment window update (ref _gw_gseg_update): on a boundary
    push a fresh segment (in_fork = rv_fork), then count the node just
    stepped onto in the newest segment."""
    B = bump.shape[0]
    dev = bump.device
    shift_nodes = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                         device=dev),
                             st.seg_nodes[:, :-1]], dim=1)
    shift_infork = torch.cat([rv_fork[:, None], st.seg_infork[:, :-1]],
                             dim=1)
    bm = bump[:, None]
    seg_nodes = torch.where(bm, shift_nodes, st.seg_nodes).clone()
    seg_infork = torch.where(bm, shift_infork, st.seg_infork)
    seg_nodes[:, 0] += adv.to(torch.int32)
    return seg_nodes, seg_infork


@dataclasses.dataclass
class _Walk:
    """What a linked walk step reads besides the state: the graph, the
    links and the options of walk_linked."""
    g: gstore.DBGraph
    links: lstore.LinkStore
    uedges: torch.Tensor
    colour: int | None
    ctpcol: int
    edge_colour: int
    missing_check: bool
    adj: torch.Tensor | None
    conf_table: torch.Tensor | None
    min_step: float
    min_cumul: float
    track_used: bool
    forced: torch.Tensor | None
    forced_n: torch.Tensor | None
    hopinfo: tuple | None
    start: torch.Tensor
    max_steps: int
    # the thresholds as float32 on the device: compared with float32
    # confidences as the JAX package's jnp.float32(min_step) is
    min_step_t: torch.Tensor | None = None
    min_cumul_t: torch.Tensor | None = None


def walk_linked(g: gstore.DBGraph, links: lstore.LinkStore,
                st: LinkedWalkState, colour: int | None, max_steps: int,
                ctpcol: int = 0, edge_colour: int = 0,
                missing_check: bool = False,
                adj: torch.Tensor | None = None,
                conf_table: torch.Tensor | None = None,
                min_step: float = -1.0, min_cumul: float = -1.0,
                track_used: bool = False,
                forced: torch.Tensor | None = None,
                forced_n: torch.Tensor | None = None,
                hopinfo=None) -> LinkedWalkState:
    """Advance all walkers until they halt or take max_steps more steps.

    forced/forced_n: context priming (ref graph_walker_prime +
    graph_walker_traverse): for its first forced_n[i] steps walker i
    takes forced[i, step] whatever the choice, picking up links and
    consuming or killing cursors as on a free walk.  The forced path must
    exist in the graph; callers skip the first forced_n outputs.

    hopinfo: from get_hopinfo: event-free unitig interiors are crossed
    in one update, recorded as hops instead of output writes (filled by
    fill_hop_outputs).  Exclusive with forced priming."""
    if hopinfo is not None and forced is not None:
        raise ValueError("hopinfo and forced priming are exclusive")
    dev = g.device
    if conf_table is not None:
        conf_table = torch.as_tensor(conf_table).to(dev, torch.float32)
    w = _Walk(g=g, links=links, uedges=gstore.cached_union_edges(g),
              colour=colour, ctpcol=ctpcol, edge_colour=edge_colour,
              missing_check=missing_check, adj=adj, conf_table=conf_table,
              min_step=min_step, min_cumul=min_cumul, track_used=track_used,
              forced=forced, forced_n=forced_n, hopinfo=hopinfo,
              start=st.base.nsteps, max_steps=max_steps,
              min_step_t=torch.tensor(min_step, dtype=torch.float32,
                                      device=dev),
              min_cumul_t=torch.tensor(min_cumul, dtype=torch.float32,
                                       device=dev))
    # both counts on every call, so the status line shows the share
    fused = _takes_kernel(w)
    count("walk.fused", int(fused))
    count("walk.plain", int(not fused))
    st, steps = (_walk_fused if fused else _walk_plain)(w, st)
    count("walk.steps", steps)
    return st


def _takes_kernel(w: _Walk) -> bool:
    """The walk kernel (csrc/walk.cu) runs a walk on CUDA tensors with the
    adjacency and without hop records, the confidence model, the
    missing-information check or used-link marks: the gap filler's walks
    (align/correct.correct_batch).  Every other walk runs the host loop."""
    return (w.g.device.type == "cuda" and w.adj is not None
            and w.hopinfo is None and w.conf_table is None
            and not w.missing_check and not w.track_used)


def _walk_plain(w: _Walk, st: LinkedWalkState):
    """The host loop: one _linked_step a step, the loop condition read once
    a step.  Returns (state, steps taken)."""
    Lmax = st.base.out_bases.shape[1]
    nl = st.used.shape[0]
    H = st.hop_v.shape[1]
    bufs = dict(out_bases=T._spare(st.base.out_bases, 0),
                out_vert=T._spare(st.base.out_vert, -1),
                used=torch.cat([st.used, st.used.new_zeros(1)]),
                hop_v=T._spare(st.hop_v, 0), hop_n=T._spare(st.hop_n, 0),
                hop_off=T._spare(st.hop_off, 0))
    steps = 0
    while bool((st.base.active
                & (st.base.nsteps - w.start < w.max_steps)).any()):
        st = _linked_step(w, st, bufs, Lmax)
        steps += 1
    return st.replace(
        base=_rbase(st.base, out_bases=bufs["out_bases"][:, :Lmax],
                    out_vert=bufs["out_vert"][:, :Lmax]),
        used=bufs["used"][:nl], hop_v=bufs["hop_v"][:, :H],
        hop_n=bufs["hop_n"][:, :H], hop_off=bufs["hop_off"][:, :H]), steps


# what a step of the kernel writes: (field, dtype, columns: 0 for a (B,)
# field, None for a (B, n) field of any n)
_KERNEL_BASE = (("idx", torch.int32, 0), ("orient", torch.uint8, 0),
                ("okm", torch.int64, None), ("active", torch.bool, 0),
                ("status", torch.int32, 0), ("nsteps", torch.int32, 0),
                ("brent_hash", torch.int64, 0),
                ("brent_steps", torch.int32, 0),
                ("brent_limit", torch.int32, 0),
                ("out_bases", torch.uint8, None),
                ("out_vert", torch.int32, None), ("out_len", torch.int32, 0))
_KERNEL_SLOTS = (("cur_link", torch.int32, CMAX),
                 ("cur_pos", torch.int32, CMAX),
                 ("cur_age", torch.int32, CMAX),
                 ("cntr_age", torch.int32, CMAX2),
                 ("seg_nodes", torch.int32, SMAX),
                 ("seg_infork", torch.bool, SMAX), ("n_drop", torch.int32, 0))


def _kernel_copy(t: torch.Tensor, name: str, dtype, cols, B: int
                 ) -> torch.Tensor:
    """A contiguous copy of state field t, which the kernel updates in
    place, after checking its type and shape."""
    if t.dtype != dtype or t.shape[0] != B or (
            cols is not None and tuple(t.shape[1:]) != ((cols,) if cols
                                                         else ())):
        raise ValueError(f"walk kernel: state field {name} is "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.clone(memory_format=torch.contiguous_format)


def _walk_fused(w: _Walk, st: LinkedWalkState):
    """The host loop of _walk_plain as one launch of the walk kernel, a
    warp a walker: the fields a step writes are copied and updated in
    place; the others are returned as they came.  Returns (state, steps
    of the longest-walking walker), the steps being the host loop's
    iteration count, since a walker never becomes active again."""
    from ..ops.kernels import _build
    g, links = w.g, w.links
    b = st.base
    B = b.idx.shape[0]
    if B == 0:
        return st, 0
    W = b.okm.shape[1]
    base = _rbase(b, **{f: _kernel_copy(getattr(b, f), f, dt, c, B)
                        for f, dt, c in _KERNEL_BASE})
    st2 = st.replace(base=base, **{
        f: _kernel_copy(getattr(st, f), f, dt, c, B)
        for f, dt, c in _KERNEL_SLOTS})
    cntr_link = st.cntr_link.contiguous()
    cntr_pos = st.cntr_pos.contiguous()
    covg, edges = g.covg.contiguous(), g.edges.contiguous()
    nseen = links.nseen.contiguous()
    seq = links.seq.contiguous()
    forced = forced_n = None
    F = 0
    if w.forced is not None:
        forced = w.forced.to(g.device, torch.uint8).contiguous()
        forced_n = w.forced_n.to(g.device, torch.int32).contiguous()
        F = forced.shape[1]
    ptrs = [w.uedges.contiguous(), covg, edges,
            w.adj.to(torch.int32).contiguous(), links.offsets.contiguous(),
            seq, links.nj.contiguous(), nseen,
            forced, forced_n, base.idx, base.orient, base.okm, base.active,
            base.status, base.nsteps, base.brent_hash, base.brent_steps,
            base.brent_limit, base.out_bases, base.out_vert, base.out_len,
            st2.cur_link, st2.cur_pos, st2.cur_age, cntr_link, cntr_pos,
            st2.cntr_age, st2.seg_nodes, st2.seg_infork, st2.n_drop]
    ints = [B, W, g.k, base.out_bases.shape[1],
            min(max(w.max_steps, 0), 2**31 - 1),
            -1 if w.colour is None else int(w.colour), covg.shape[1],
            w.edge_colour, links.nlinks, seq.shape[1], w.ctpcol,
            nseen.shape[1], F]
    fn = _build.function("walk", "mctx_walk", len(ptrs), len(ints))
    with torch.cuda.device(g.device):
        rc = fn(*[None if t is None else t.data_ptr() for t in ptrs], *ints,
                _build.stream_of(base.idx))
    _build.check(rc, "walk")
    steps = int((base.nsteps - b.nsteps).max())
    return st2, steps


def _linked_step(w: _Walk, st: LinkedWalkState, bufs: dict, Lmax: int
                 ) -> LinkedWalkState:
    """One step of every walker (the body of the JAX package's
    walk_linked).  The output, `used` and hop buffers of `bufs` (each
    with a spare column or slot) are written in place; the returned
    state's fields for them are left stale."""
    g, links = w.g, w.links
    b = st.base
    B = b.idx.shape[0]
    dev = b.idx.device
    ar = torch.arange(B, device=dev)
    # with no links no cursor can exist: the choice is the linkless one,
    # and every cursor, counter, confidence and pickup update is a no-op
    nolinks = links.nlinks == 0
    pop_nib, col_nib = T._candidates(g, b, w.colour, w.adj, w.uedges)
    if nolinks:
        nuc, go, status = T.choose_linkless(pop_nib, col_nib)
    else:
        bases = _cursor_bases(links, st)
        nuc, go, status, path_gap = _choose_linked(
            links, st, bases, pop_nib, col_nib, w.missing_check)
    is_fork = status == T.USELINKS
    if w.forced is not None:
        fstep = b.nsteps - w.start
        take = b.active & (fstep < w.forced_n)
        fn = w.forced[ar, fstep.clamp(0, w.forced.shape[1] - 1).long()]
        nuc = torch.where(take, fn, nuc).to(torch.uint8)
        go = go | take
        # cursors are consumed at in-colour forks on forced steps too
        # (ref _graph_walker_force_jump is_fork argument)
        cnt = T._table("pop4", E.POPCOUNT4, dev)[col_nib.long()]
        is_fork = torch.where(take, cnt > 1, is_fork)
    adv = b.active & go
    lost_nuc = kops.first_base(b.okm, g.k)
    nxt_okm = kops.shift_append(b.okm, nuc, g.k)
    if w.adj is not None:
        v = b.idx.long() * 2 + b.orient.long()
        nv = adjmod.adj_at(w.adj, v, nuc).clamp(min=0)
        j = nv >> 1
        o2 = (nv & 1).to(torch.uint8)
    else:
        key2, o2 = kops.canonical(nxt_okm, g.k)
        j, _found = sops.lookup(g.keys, key2)
    idx = torch.where(adv, j, b.idx).to(torch.int32)
    orient = torch.where(adv, o2, b.orient).to(torch.uint8)
    nb = _rbase(b, okm=torch.where(adv[:, None], nxt_okm, b.okm), idx=idx,
                orient=orient)

    # 1) cursor advancement on resolved forks
    if nolinks:
        move_fork = adv & is_fork
        cur_link, cur_pos = st.cur_link, st.cur_pos
    else:
        cur_link, cur_pos, match, exhausted, live, move_fork = _cursor_step(
            links, st, bases, nuc, adv, is_fork)
    mf = move_fork[:, None]

    # 1b) counter cursors advance on forks too; they die on a mismatch or
    # when the NEXT position would be the last (force_jump :586-597)
    if w.missing_check and not nolinks:
        cmatch = ((_cntr_bases(links, st) == nuc[:, None])
                  & (st.cntr_pos + 1 < _nj_of(links, st.cntr_link)))
        ckeep = (st.cntr_link >= 0) & (~mf | cmatch)
        cntr_pos = torch.where(mf & ckeep, st.cntr_pos + 1, st.cntr_pos)
        cntr_link = torch.where(ckeep, st.cntr_link, -1)
    else:
        cntr_pos, cntr_link = st.cntr_pos, st.cntr_link

    # 1c) a cursor that matched its LAST junction at a resolved fork was
    # followed start to end: mark its link used (ref
    # graph_walker.c:576-579)
    if w.track_used and not nolinks:
        done = live & mf & match & exhausted
        nl = bufs["used"].shape[0] - 1
        bufs["used"][torch.where(done, st.cur_link, nl).long().reshape(-1)] \
            = True

    # 2) segment boundary: out-fork taken or in-merge at the new node
    rv_fork = _other_prev_exists(g, nb, lost_nuc, w.edge_colour) & adv
    bump = move_fork | rv_fork
    cur_age = st.cur_age if nolinks else torch.where(
        bump[:, None] & (cur_link >= 0), st.cur_age + 1, st.cur_age)
    seg_nodes, seg_infork = _segments(st, bump, rv_fork, adv)

    # confidence model (ref assemble_contigs.c:100-117): on a USELINKS
    # step, gap = path_gap + k-1 + 2 bp; the cumulative product, float32
    if w.conf_table is not None and not nolinks:
        gap_bp = path_gap + (g.k - 1) + 2
        tlen = w.conf_table.shape[0]
        confid = torch.where(
            gap_bp < tlen, w.conf_table[gap_bp.clamp(0, tlen - 1).long()],
            torch.zeros((), dtype=torch.float32, device=dev))
        is_use = (status == T.USELINKS) & adv
        cum_conf = torch.where(is_use, st.cum_conf * confid, st.cum_conf)
        max_gap = torch.where(is_use, torch.maximum(st.max_gap, gap_bp),
                              st.max_gap)
        low_step = (is_use & (confid < w.min_step_t) if w.min_step >= 0
                    else torch.zeros_like(is_use))
        low_cum = (is_use & (cum_conf < w.min_cumul_t) if w.min_cumul >= 0
                   else torch.zeros_like(is_use))
    else:
        cum_conf, max_gap = st.cum_conf, st.max_gap
        low_step = low_cum = torch.zeros_like(adv)

    st2 = st.replace(base=nb, cur_link=cur_link, cur_pos=cur_pos,
                     cur_age=cur_age, cntr_link=cntr_link,
                     cntr_pos=cntr_pos, seg_nodes=seg_nodes,
                     seg_infork=seg_infork, cum_conf=cum_conf,
                     max_gap=max_gap)

    # 2b) counter pickup at the new node's other predecessors; the age
    # bump then lands on them too (_gw_gseg_update after
    # add_counter_paths)
    if not nolinks:
        if w.missing_check:
            st2 = _pickup_counter(g, links, st2, adv, lost_nuc, w.ctpcol,
                                  w.edge_colour, w.adj)
        st2 = st2.replace(cntr_age=torch.where(
            bump[:, None] & (st2.cntr_link >= 0), st2.cntr_age + 1,
            st2.cntr_age))

    # 3) pick up links at the new node (advancing walkers only)
    st2 = st2.replace(base=_rbase(st2.base, active=adv))
    st2 = _pickup(links, st2, w.ctpcol)

    # 4) Brent cycle check on the full linked state (with no cursor, the
    # cursors' share of the hash is 0)
    h = kops.kmer_hash(st2.base.okm) if nolinks else _linked_hash(st2)
    nb2, cyc = T.brent_update(st2.base, h, adv)
    adv2 = adv & ~cyc

    # 5) output base
    hit_max = adv2 & (b.out_len >= Lmax)
    writes = adv2 & ~hit_max
    pos_w = torch.where(writes, b.out_len, Lmax).long()   # Lmax: spare
    bufs["out_bases"][ar, pos_w] = nuc.to(torch.uint8)
    bufs["out_vert"][ar, pos_w] = idx * 2 + orient.to(torch.int32)
    out_len = torch.where(writes, b.out_len + 1, b.out_len)
    new_status = torch.where(
        adv, torch.where(cyc, T.HALT_CYCLE,
                         torch.where(hit_max, T.HALT_MAXLEN, status)),
        torch.where(b.active, status, b.status))
    # confidence halts land AFTER the step is written (the reference
    # breaks after db_node_buf_add, assemble_contigs.c:100-117)
    new_status = torch.where(low_step, T.LOW_STEP_CONF,
                             torch.where(low_cum, T.LOW_CUMUL_CONF,
                                         new_status))
    active = b.active & go & ~cyc & ~hit_max & ~low_step & ~low_cum
    nb2 = _rbase(nb2, out_len=out_len.to(torch.int32),
                 status=new_status.to(torch.int32), active=active,
                 nsteps=(b.nsteps + b.active.to(torch.int32)))
    if w.hopinfo is not None:
        nb2, st2 = _hop(w, st2, nb2, bufs, writes, Lmax)
    return st2.replace(base=nb2)


def _hop(w: _Walk, st2, nb2, bufs, writes, Lmax):
    """Unitig-interior hop: the node just arrived at had its full arrival
    processing; if the next jump[v] vertices are event-free (no links, no
    degree changes, no cycles) nothing in the linked state changes across
    them, so they are crossed in one update and recorded as a hop.

    A hop cut short by the room left in the output or in the step budget
    (J < jump[v]) lands J positions ahead in walk order, on the vertex a
    walk without hops reaches.  The JAX package moves to the full jump's
    target whatever J is (mccortex_tpu/links/walk.py:732-738), so its
    output skips the vertices between them (ROADMAP.md Queue 3)."""
    jump_arr, order_t, pos_t = w.hopinfo
    v_now = nb2.idx.long() * 2 + nb2.orient.long()
    room_len = Lmax - nb2.out_len
    room_steps = w.max_steps - (nb2.nsteps - w.start)
    J = torch.minimum(jump_arr[v_now], torch.minimum(room_len, room_steps))
    can = nb2.active & writes & (J > 0) & (st2.hop_cnt < HOP_CAP)
    ar = torch.arange(v_now.shape[0], device=v_now.device)
    slot = torch.where(can, st2.hop_cnt, HOP_CAP).long()
    bufs["hop_v"][ar, slot] = v_now.to(torch.int32)
    bufs["hop_n"][ar, slot] = J.to(torch.int32)
    bufs["hop_off"][ar, slot] = nb2.out_len
    Jw = torch.where(can, J, 0).to(torch.int32)
    p = (pos_t[v_now] + torch.where(can, J, 0)).clamp(0, order_t.shape[0] - 1)
    tgt = order_t[p].long()
    new_idx = torch.where(can, tgt >> 1, nb2.idx.long())
    new_or = torch.where(can, tgt & 1, nb2.orient.long()).to(torch.uint8)
    new_okm = torch.where(can[:, None],
                          kops.oriented(w.g.keys[new_idx], new_or, w.g.k),
                          nb2.okm)
    nb2 = _rbase(nb2, idx=new_idx.to(torch.int32), orient=new_or,
                 okm=new_okm, out_len=nb2.out_len + Jw,
                 nsteps=nb2.nsteps + Jw)
    seg_nodes = st2.seg_nodes.clone()
    seg_nodes[:, 0] += Jw
    return nb2, st2.replace(seg_nodes=seg_nodes,
                            hop_cnt=st2.hop_cnt + can.to(torch.int32))


def walk_linked_chunked(g, links, st, colour, max_steps, ctpcol=0,
                        missing_check=False, adj=None, chunk=512,
                        conf_table=None, min_step=-1.0, min_cumul=-1.0,
                        track_used=False, hopinfo=None):
    """Resumable linked walking: repeated bounded walk_linked calls.  As
    in graph/traverse.walk_chunked, the all-halted check runs one chunk
    behind (a chunk on a fully halted state is a no-op).  With hopinfo a
    chunk's step budget covers hopped nodes too."""
    done = 0
    prev_active = None
    while done < max_steps:
        take = min(chunk, max_steps - done)
        st = walk_linked(g, links, st, colour, max_steps=take,
                         ctpcol=ctpcol, missing_check=missing_check,
                         adj=adj, conf_table=conf_table,
                         min_step=min_step, min_cumul=min_cumul,
                         track_used=track_used, hopinfo=hopinfo)
        done += take
        act = bool(st.base.active.any())
        if prev_active is not None and not prev_active:
            break
        prev_active = act
    return st


# ---------------------------------------------------------------------------
# unitig-interior hops: links attach only at unitig heads and tails
# (thread.py attaches next to junctions), cursors advance only at
# in-colour forks (unitig tails), ages change only at forks and in-merges,
# and a single-out-edge step always proceeds, so the stretch of chain
# vertices between events is walkable in one state update.  Event
# vertices: chain heads, chain tails, vertices carrying links, cycle
# unitigs and sentinels.
# ---------------------------------------------------------------------------

_hopinfo = Memo()
_positions_of = Memo()


def _positions(order: np.ndarray) -> np.ndarray:
    """The inverse of the walk order (a vertex's position in it),
    memoised on the order array."""
    def make():
        pos = np.empty(order.shape[0], np.int64)
        pos[order] = np.arange(order.shape[0])
        return pos
    return _positions_of.get((order,), make)


def _layout(g: gstore.DBGraph):
    """The unitig walk-order layout of graph/traverse._chain_layout."""
    from ..graph import unitigs as U
    uv = U.cached_unitig_view(g.keys, gstore.cached_union_edges(g), g.k)
    return T._chain_layout(uv, T.cached_emit_chars(g.keys, g.k))


def get_hopinfo(g: gstore.DBGraph, links: lstore.LinkStore):
    """(jump, order, pos) (2N,) int32 tensors on g's device: jump[v] =
    the number of event-free vertices following v along its unitig
    chain; order = the vertices in walk order (graph/traverse.
    _chain_layout) and pos its inverse, so a hop of J <= jump[v] lands on
    order[pos[v] + J].  Memoised per (store keys, link offsets), so a
    second link file on one graph never reads the first one's hops."""
    return _hopinfo.get((g.keys, links.offsets),
                        lambda: _make_hopinfo(g, links))


def _make_hopinfo(g: gstore.DBGraph, links: lstore.LinkStore):
    with span("hopinfo", g.device):
        end, dist, is_cyc, order, _sorted_chars, run_start = _layout(g)
        P2 = order.shape[0]
        pos_of = _positions(order)
        deg = np.diff(links.offsets.cpu().numpy())
        has_link = np.zeros(P2, bool)
        has_link[:min(deg.shape[0], P2)] = deg[:P2] > 0
        tail = dist == 0
        head = pos_of == run_start[end]
        cyc_v = np.repeat(np.asarray(is_cyc, bool), 2)
        live_v = np.repeat(~sops.is_sentinel(g.keys).cpu().numpy(), 2)
        event = head | tail | has_link | cyc_v | ~live_v

        ev_at_pos = event[order]
        idxs = np.arange(P2, dtype=np.int64)
        evpos = np.where(ev_at_pos, idxs, P2 + 1)
        sufmin = np.minimum.accumulate(evpos[::-1])[::-1]
        nse = np.empty(P2, np.int64)
        nse[:-1] = sufmin[1:]
        nse[-1] = P2 + 1
        jump_pos = np.clip(nse - idxs - 1, 0, None)
        jump_pos[tail[order]] = 0        # never jump across a chain end
        jump_pos[cyc_v[order]] = 0
        jump_v = np.zeros(P2, np.int32)
        jump_v[order] = jump_pos.astype(np.int32)
        return tuple(torch.from_numpy(a.astype(np.int32)).to(g.device)
                     for a in (jump_v, order, pos_of))


def _pack2_dev(ob: torch.Tensor, Lc: int) -> torch.Tensor:
    """(B, L) uint8 base codes -> (B, Lc//4) uint8, 4 codes a byte (Lc
    may exceed L by up to 3 when L is not a multiple of 4)."""
    if Lc > ob.shape[1]:
        ob = torch.cat([ob, ob.new_zeros((ob.shape[0], Lc - ob.shape[1]))],
                       dim=1)
    q = (ob[:, :Lc] & 3).reshape(ob.shape[0], Lc // 4, 4)
    return (q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4)
            | (q[:, :, 3] << 6))


# the four 2-bit codes of every byte, low bits first
_UNPACK2 = ((np.arange(256)[:, None] >> np.array([0, 2, 4, 6])) & 3
            ).astype(np.uint8)


def _unpack2_np(packed: np.ndarray, Lc: int) -> np.ndarray:
    return _UNPACK2[packed].reshape(packed.shape[0], -1)[:, :Lc]


def fill_hop_outputs(g: gstore.DBGraph, st: LinkedWalkState,
                     verts: bool = True, verts_cols: int | None = None):
    """Host: fill the out_bases/out_vert gaps left by interior hops from
    the unitig walk-order layout.  Returns (out_bases, out_vert) numpy
    arrays of width Lc = the power-of-two bucket covering max(out_len)
    (not the whole max_len buffer); the base plane crosses 2-bit packed,
    and the vertex plane only when asked for (verts_cols: just its first
    columns).  Past each walker's out_len, out_bases is 0 and out_vert
    is -1."""
    ol = st.base.out_len.cpu().numpy()
    Lmax = st.base.out_bases.shape[1]
    Lc = 4
    while Lc < min(int(ol.max(initial=0)), Lmax):
        Lc *= 2
    Lc = min(Lc, -(-Lmax // 4) * 4)   # pow2 bucket, capped at ceil4(Lmax)
    # nothing past out_len reads as a base or a vertex
    past = (torch.arange(min(Lc, Lmax), device=st.base.out_len.device
                         )[None, :] >= st.base.out_len[:, None])
    obt = torch.where(past, 0, st.base.out_bases[:, :Lc])
    ob = _unpack2_np(_pack2_dev(obt, Lc).cpu().numpy(), Lc)
    W = min(Lc, Lmax) if verts_cols is None else min(verts_cols, Lmax)
    if not verts or W == 0:
        ov = np.full((ob.shape[0], W), -1, np.int32) if verts else None
    else:
        ov = torch.where(past[:, :W], -1, st.base.out_vert[:, :W]
                         ).cpu().numpy()
    hc = st.hop_cnt.cpu().numpy()
    if hc.max(initial=0) > 0:
        _end, _dist, _cyc, order, sorted_chars, _rs = _layout(g)
        pos_of = _positions(order)
        h = int(hc.max())
        take = np.arange(h)[None, :] < hc[:, None]
        bi = np.nonzero(take)[0]
        hv, hn, ho = (t[:, :h].cpu().numpy()[take].astype(np.int64)
                      for t in (st.hop_v, st.hop_n, st.hop_off))
        # every hop's stretch at once: output column off + i takes layout
        # position pos_of[v] + 1 + i, for i < n
        n = np.maximum(hn, 0)
        seg = np.repeat(np.arange(len(n)), n)
        i = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        row, col = bi[seg], ho[seg] + i
        src = pos_of[hv[seg]] + 1 + i
        inb = col < Lc
        ob[row[inb], col[inb]] = sorted_chars[src[inb]]
        if ov is not None:
            inv = col < W
            ov[row[inv], col[inv]] = order[src[inv]]
    return ob, ov


def _join(seed_strs, fw_b, fw_l, rv_b, rv_l, mids=None) -> list:
    """contig i = revcomp(left half) + seed (or mid) + right half."""
    contigs = []
    for i in range(len(seed_strs)):
        right = _CHARS[fw_b[i, :fw_l[i]]].tobytes().decode()
        left = _CHARS[3 - rv_b[i, :rv_l[i]][::-1]].tobytes().decode()
        mid = seed_strs[i] if mids is None else mids[i]
        contigs.append(left + mid + right)
    return contigs


def _seed_strings(g: gstore.DBGraph, rows: np.ndarray) -> list:
    keys = g.keys[torch.as_tensor(np.asarray(rows, np.int64)).to(g.device)]
    return kmers_to_strings(keys.cpu().numpy().view(np.uint64), g.k)


def assemble_contigs_linked(g: gstore.DBGraph, links: lstore.LinkStore,
                            seed_rows: np.ndarray, colour: int | None = 0,
                            max_len: int = 4096, ctpcol: int = 0,
                            missing_check: bool = False):
    """Linked contig assembly from cold starts in both directions (ref
    assemble_contigs.c with paths, no confidence model).  Returns
    (contigs, stop statuses (B, 2))."""
    B = len(seed_rows)
    if B == 0:
        return [], np.zeros((0, 2), np.int32)
    seeds = torch.as_tensor(np.asarray(seed_rows)).to(g.device, torch.int32)
    adj = adjmod.get_adjacency(g)
    hopinfo = get_hopinfo(g, links)
    halves, stats = [], []
    for o in (0, 1):
        st = linked_init(g, links, seeds,
                         torch.full((B,), o, dtype=torch.uint8), max_len,
                         ctpcol)
        st = walk_linked_chunked(g, links, st, colour, max_len + 1,
                                 ctpcol=ctpcol, missing_check=missing_check,
                                 adj=adj, hopinfo=hopinfo, chunk=4096)
        ob, _ov = fill_hop_outputs(g, st, verts=False)
        halves.append((ob, st.base.out_len.cpu().numpy()))
        stats.append(st.base.status.cpu().numpy())
        report_drops(st, "contigs")
    (fw_b, fw_l), (rv_b, rv_l) = halves
    contigs = _join(_seed_strings(g, seed_rows), fw_b, fw_l, rv_b, rv_l)
    return contigs, np.stack(stats, axis=1)


def walk_along(g: gstore.DBGraph, links: lstore.LinkStore,
               st: LinkedWalkState, path_verts: torch.Tensor,
               path_len: torch.Tensor, ctpcol: int = 0,
               edge_colour: int = 0) -> LinkedWalkState:
    """Force each walker along its prescribed vertex path, picking up
    links and updating cursors (role of ref graph_walker_traverse /
    graph_walker_prime, graph_walker.c:709-726).

    path_verts: (B, C) vertices; st must sit at path_verts[:, 0] (with
    its pickup done).  Walkers advance to path_verts[:, i] for i = 1 ..
    path_len - 1; nothing is written to the output buffers.  The loop
    ends at the longest path: later JAX iterations move no walker."""
    B, C = path_verts.shape
    dev = g.device
    path_verts = torch.as_tensor(path_verts).to(dev, torch.int32)
    path_len = torch.as_tensor(path_len).to(dev, torch.int32)
    pop4 = T._table("pop4", E.POPCOUNT4, dev)
    n_iter = min(C, int(path_len.max()) if B else 0)
    for i in range(1, n_iter):
        b = st.base
        on_path = (i < path_len) & b.active
        # is_fork: out-degree in the edge colour at the CURRENT node
        nib = E.with_orientation(g.edges[b.idx.long(), edge_colour],
                                 b.orient)
        is_fork = pop4[nib.long()] > 1
        nxt_v = path_verts[:, i].long()
        j = nxt_v.clamp(min=0) >> 1     # padded (-1) rows are masked off
        o2 = (nxt_v.clamp(min=0) & 1).to(torch.uint8)
        okm2 = kops.oriented(g.keys[j], o2, g.k)
        nuc = (okm2[:, -1] & 3).to(torch.uint8)
        lost_nuc = kops.first_base(b.okm, g.k)
        adv = on_path & (nxt_v >= 0)
        nb = _rbase(b, okm=torch.where(adv[:, None], okm2, b.okm),
                    idx=torch.where(adv, j, b.idx.long()).to(torch.int32),
                    orient=torch.where(adv, o2, b.orient).to(torch.uint8))
        bases = _cursor_bases(links, st)
        cur_link, cur_pos, _m, _e, _l, move_fork = _cursor_step(
            links, st, bases, nuc, adv, is_fork)
        rv_fork = _other_prev_exists(g, nb, lost_nuc, edge_colour) & adv
        bump = move_fork | rv_fork
        cur_age = torch.where(bump[:, None] & (cur_link >= 0),
                              st.cur_age + 1, st.cur_age)
        # the segment window stays in sync with the ages during priming
        # (ref graph_walker_prime -> force_jump -> _gw_gseg_update)
        seg_nodes, seg_infork = _segments(st, bump, rv_fork, adv)
        st2 = st.replace(base=_rbase(nb, active=adv), cur_link=cur_link,
                         cur_pos=cur_pos, cur_age=cur_age,
                         seg_nodes=seg_nodes, seg_infork=seg_infork)
        # pickup at the new node (advancing walkers only)
        st2 = _pickup(links, st2, ctpcol)
        st = st2.replace(base=_rbase(st2.base, active=b.active))
    return st.replace(base=_rbase(
        st.base, brent_hash=_linked_hash(st),
        brent_steps=torch.zeros_like(st.base.brent_steps),
        brent_limit=torch.ones_like(st.base.brent_limit)))


def assemble_contigs_primed(g: gstore.DBGraph, links: lstore.LinkStore,
                            seed_rows: np.ndarray, colour: int | None = 0,
                            max_len: int = 4096, ctpcol: int = 0,
                            max_context: int = 200,
                            missing_check: bool = False,
                            conf_table=None, min_step: float = -1.0,
                            min_cumul: float = -1.0,
                            track_used: bool = False,
                            return_extra: bool = False):
    """Contig assembly with direction-1 priming (ref assemble_contigs.c:
    88-90): after walking direction 0, the second direction's walker is
    primed along the reversed direction-0 path, so links picked up on
    the way resolve forks behind the seed."""
    B = len(seed_rows)
    if B == 0:
        return [], np.zeros((0, 2), np.int32)
    dev = g.device
    seed_rows = np.asarray(seed_rows, np.int64)
    seeds = torch.from_numpy(seed_rows).to(dev, torch.int32)
    adj = adjmod.get_adjacency(g)
    hopinfo = get_hopinfo(g, links)
    kw = dict(ctpcol=ctpcol, missing_check=missing_check, adj=adj,
              conf_table=conf_table, min_step=min_step, min_cumul=min_cumul,
              track_used=track_used, hopinfo=hopinfo, chunk=4096)
    with span("walk", dev):
        # direction 0: cold start at (seed, FORWARD)
        st0 = linked_init(g, links, seeds,
                          torch.zeros((B,), dtype=torch.uint8), max_len,
                          ctpcol)
        st0 = walk_linked_chunked(g, links, st0, colour, max_len + 1, **kw)
    fw_l = st0.base.out_len.cpu().numpy()
    # direction-1 context: the reversed direction-0 path (vertices
    # flipped), cut to its last max_context nodes, ending AT the seed;
    # only the head window of the vertex plane crosses to the host
    C = int(min(max_context, max(int(fw_l.max()), 0) + 1))
    with span("fill"):
        fw_b, fw_v = fill_hop_outputs(g, st0, verts_cols=max(C - 1, 0))
    ctx_verts = np.full((B, max(C, 1)), -1, np.int32)
    ctx_len = np.zeros(B, np.int32)
    seed_v1 = (seed_rows * 2 + 1).astype(np.int32)
    for b in range(B):
        take = min(int(fw_l[b]), C - 1)
        # dir 0 went seed -> v1 -> ... -> vL; reversed with flips:
        # flip(v_take) ... flip(v1), then the seed reversed
        path = [int(v) ^ 1 for v in fw_v[b, :take][::-1].tolist()]
        path.append(int(seed_v1[b]))
        ctx_verts[b, :len(path)] = path
        ctx_len[b] = len(path)
    has = ctx_len > 0
    start_rows = np.where(has, ctx_verts[:, 0] >> 1, seed_rows)
    start_or = np.where(has, ctx_verts[:, 0] & 1, 1).astype(np.uint8)
    with span("walk", dev):
        st1 = linked_init(g, links, torch.from_numpy(start_rows),
                          torch.from_numpy(start_or), max_len, ctpcol)
        st1 = walk_along(g, links, st1, torch.from_numpy(ctx_verts),
                         torch.from_numpy(ctx_len), ctpcol=ctpcol)
        st1 = walk_linked_chunked(g, links, st1, colour, max_len + 1, **kw)
    with span("fill"):
        rv_b, _rv_v = fill_hop_outputs(g, st1, verts=False)
    rv_l = st1.base.out_len.cpu().numpy()
    contigs = _join(_seed_strings(g, seed_rows), fw_b, fw_l, rv_b, rv_l)
    stats = np.stack([st0.base.status.cpu().numpy(),
                      st1.base.status.cpu().numpy()], axis=1)
    if return_extra:
        extra = {
            "cum_conf": np.stack([st0.cum_conf.cpu().numpy(),
                                  st1.cum_conf.cpu().numpy()], axis=1),
            "max_gap": np.stack([st0.max_gap.cpu().numpy(),
                                 st1.max_gap.cpu().numpy()], axis=1),
            "used": (st0.used | st1.used).cpu().numpy(),
            "n_drop": int(st0.n_drop.sum()) + int(st1.n_drop.sum()),
        }
        return contigs, stats, extra
    return contigs, stats


# ---------------------------------------------------------------------------
# link fetch: follow a link's junction choices through the graph (role of
# ref gpath_fetch, gpath_checks.c:199-234)
# ---------------------------------------------------------------------------

def link_vertices(links: lstore.LinkStore, N: int) -> np.ndarray:
    """Vertex (2*row + orient) of every link id (host, from the CSR
    offsets)."""
    offs = links.offsets.cpu().numpy()
    return np.repeat(np.arange(2 * N), np.diff(offs))


def _fetch_links(g: gstore.DBGraph, links: lstore.LinkStore,
                 start_vert: torch.Tensor, link_ids: torch.Tensor,
                 edge_colour: int, max_steps: int, adj=None):
    """Follow each link from its vertex: at a fork take the link's next
    junction base, elsewhere the single edge.  A host loop over the JAX
    package's while_loop, leaving when no walker is active."""
    B = start_vert.shape[0]
    dev = g.device
    ar = torch.arange(B, device=dev)
    pop4 = T._table("pop4", E.POPCOUNT4, dev)
    idx = (start_vert >> 1).to(torch.int32)
    orient = (start_vert & 1).to(torch.uint8)
    nj = (links.nj[link_ids.long()] if links.nlinks
          else torch.zeros((B,), dtype=torch.int32, device=dev))
    out_vert = torch.full((B, max_steps + 2), -1, dtype=torch.int32,
                          device=dev)   # the last column takes drops
    out_vert[:, 0] = start_vert
    okm = kops.oriented(g.keys[idx.long()], orient, g.k)
    pos = torch.zeros((B,), dtype=nj.dtype, device=dev)
    ln = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = nj > 0
    ok = torch.ones((B,), dtype=torch.bool, device=dev)
    done = nj <= 0
    while bool(active.any()):
        nib = E.with_orientation(g.edges[idx.long(), edge_colour], orient)
        outdeg = pop4[nib.long()]
        at_fork = outdeg > 1
        jb = (_junc_bases(links, link_ids, pos) if links.nlinks
              else torch.zeros((B,), dtype=torch.uint8, device=dev))
        # single-edge base (the table's value for a nibble of one bit; it
        # is taken only where the out-degree is at most 1)
        single = T._table("nib2nuc", T._NIB2NUC, dev)[nib.long()]
        nuc = torch.where(at_fork, jb, single).to(torch.uint8)
        has_edge = ((nib >> nuc) & 1).bool()
        adv = active & (outdeg > 0) & has_edge & (~at_fork | (pos < nj))
        nxt_okm = kops.shift_append(okm, nuc, g.k)
        if adj is not None:
            v = idx.long() * 2 + orient.long()
            nv = adjmod.adj_at(adj, v, nuc).clamp(min=0)
            j = nv >> 1
            o2 = (nv & 1).to(torch.uint8)
        else:
            key2, o2 = kops.canonical(nxt_okm, g.k)
            j, _found = sops.lookup(g.keys, key2)
        pos2 = torch.where(adv & at_fork, pos + 1, pos)
        ln2 = torch.where(adv, ln + 1, ln)
        out_vert[ar, torch.where(adv, ln2, max_steps + 1).long()] = \
            (j * 2 + o2.to(j.dtype)).to(torch.int32)
        # done once every junction is consumed (last junction node added)
        fin = pos2 >= nj
        ok = ok & ~(active & ~adv)
        done = done | (adv & fin)
        okm = torch.where(adv[:, None], nxt_okm, okm)
        idx = torch.where(adv, j, idx).to(torch.int32)
        orient = torch.where(adv, o2, orient).to(torch.uint8)
        pos, ln = pos2, ln2
        active = adv & ~fin & (ln2 < max_steps)
    return out_vert[:, :max_steps + 1], ln + 1, ok & done


def fetch_link_paths(g: gstore.DBGraph, links: lstore.LinkStore,
                     link_ids: np.ndarray, edge_colour: int = 0,
                     max_steps: int = 2048, adj=None):
    """Follow each link from its kmer through the graph.  Returns (verts
    (B, max_steps+1) int32 padded -1, lens (B,), ok (B,)): ok means every
    junction was consumed with a matching edge (the link is walkable,
    ref gpath_checks.c)."""
    if len(link_ids) == 0:
        return (np.zeros((0, max_steps + 1), np.int32),
                np.zeros((0,), np.int32), np.zeros((0,), bool))
    lv = link_vertices(links, g.capacity)
    link_ids = np.asarray(link_ids, np.int64)
    start = torch.from_numpy(lv[link_ids].astype(np.int32)).to(g.device)
    v, ln, ok = _fetch_links(g, links, start,
                             torch.from_numpy(link_ids).to(g.device),
                             edge_colour, max_steps, adj)
    return v.cpu().numpy(), ln.cpu().numpy(), ok.cpu().numpy()


def assemble_contigs_from_paths(g: gstore.DBGraph, links: lstore.LinkStore,
                                link_ids: np.ndarray,
                                colour: int | None = 0,
                                max_len: int = 4096, ctpcol: int = 0,
                                missing_check: bool = False,
                                conf_table=None, min_step: float = -1.0,
                                min_cumul: float = -1.0):
    """Contigs seeded from whole link paths (ref assemble_contigs.c:
    273-306 _assemble_from_paths: fetch the link's node path, prime the
    walker along it, extend both directions)."""
    B = len(link_ids)
    if B == 0:
        return [], np.zeros((0, 2), np.int32)
    dev = g.device
    adj = adjmod.get_adjacency(g)
    verts, lens, _ok = fetch_link_paths(g, links, link_ids, max_steps=max_len,
                                        adj=adj)
    kw = dict(ctpcol=ctpcol, missing_check=missing_check, adj=adj,
              conf_table=conf_table, min_step=min_step, min_cumul=min_cumul)

    def extend(pv, pl):
        st = linked_init(g, links, torch.from_numpy(pv[:, 0] >> 1),
                         torch.from_numpy((pv[:, 0] & 1).astype(np.uint8)),
                         max_len, ctpcol)
        st = walk_along(g, links, st, torch.from_numpy(pv),
                        torch.from_numpy(pl), ctpcol=ctpcol)
        st = walk_linked_chunked(g, links, st, colour, max_len + 1, **kw)
        return (st.base.out_bases.cpu().numpy(),
                st.base.out_len.cpu().numpy(), st.base.status.cpu().numpy())

    # dir 0: prime along the fetched path, then extend
    fw_b, fw_l, stat0 = extend(verts, lens)
    # dir 1: prime along the reversed, flipped path
    rv = np.full_like(verts, -1)
    for b in range(B):
        L = int(lens[b])
        rv[b, :L] = verts[b, :L][::-1] ^ 1
    rv_b, rv_l, stat1 = extend(rv, lens.copy())

    # path string: the kmer of vertex 0 + the last bases of the rest
    Cw = verts.shape[1]
    vt = torch.from_numpy(np.maximum(verts, 0).reshape(-1)).to(dev).long()
    okm = kops.oriented(g.keys[vt >> 1], (vt & 1).to(torch.uint8), g.k)
    lastb = (okm[:, -1] & 3).cpu().numpy().reshape(B, Cw)
    seed_strs = _seed_strings(g, np.maximum(verts[:, 0], 0) >> 1)
    mids = [seed_strs[i] + _CHARS[lastb[i, 1:int(lens[i])]].tobytes().decode()
            for i in range(B)]
    return (_join(seed_strs, fw_b, fw_l, rv_b, rv_l, mids),
            np.stack([stat0, stat1], axis=1))

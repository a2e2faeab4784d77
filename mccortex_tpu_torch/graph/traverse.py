"""Batched graph traversal; counterpart of mccortex_tpu/graph/traverse.py.

B walkers advance in lockstep as tensors of state; halted walkers are
masked.  Where the JAX package runs a fixed-shape step under
`lax.while_loop`, this module runs the same step in a host loop and
reads the loop condition once a step (one sync).  The decision table is
the linkless one of the reference (graph_walker.c states 0-5); cycles
are caught by Brent's algorithm on a hash of the walker state.

Two walkers:

- `walk`: one base a step (the kmer walker), with or without the
  precomputed adjacency;
- `hop_walk`: one whole unitig a step (the unitig-hop walker), on the
  unitig view of graph/unitigs.py; it always uses the adjacency.

Writes that the JAX package drops with `mode="drop"` at an index one past
the end go here into one spare column, sliced off before the state is
returned.  uint64 hashes travel as int64 bit views.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kmer as kops
from ..ops import sorted as sops
from ..utils.memo import Memo
from ..utils.text import kmers_to_strings
from ..utils.timing import span
from . import adjacency as adjmod
from . import edges as E
from . import store as gstore

# GraphStep statuses (ref graph_step.h:10-21)
POPFWD = 0
COLFWD = 1
POPFRK_COLFWD = 2
NOCOVG = 3
NOCOLCOVG = 4
NOLINKS = 5
SPLIT_LINKS = 6
MISSING_LINKS = 7
USELINKS = 8
# extra halt reasons (assemble_contigs.c graphstep2assem)
HALT_CYCLE = 9
HALT_MAXLEN = 10
LOW_STEP_CONF = 11   # ref assemble_contigs.c low_step_confid
LOW_CUMUL_CONF = 12  # ref assemble_contigs.c low_cumul_confid

STATUS_STR = ["GoPopForward", "GoColForward", "GoPopForkColForward",
              "FailNoCovg", "FailNoColCovg", "FailNoLinks",
              "FailSplitLinks", "FailMissingLinks", "GoUseLinks",
              "HitCycle", "HitMaxLen", "LowStepConfidence",
              "LowCumulConfidence"]

_CHARS = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class WalkState:
    idx: torch.Tensor          # (B,) int32 current node row
    orient: torch.Tensor       # (B,) uint8
    okm: torch.Tensor          # (B, W) int64 oriented kmer (as walked)
    active: torch.Tensor       # (B,) bool
    status: torch.Tensor       # (B,) int32 last step status / halt reason
    nsteps: torch.Tensor       # (B,) int32
    brent_hash: torch.Tensor   # (B,) int64 (uint64 bits) checkpoint hash
    brent_steps: torch.Tensor  # (B,) int32 steps since checkpoint
    brent_limit: torch.Tensor  # (B,) int32 current checkpoint interval
    out_bases: torch.Tensor    # (B, Lmax) uint8 bases appended so far
    out_vert: torch.Tensor     # (B, Lmax) int32 vertex (2*idx+orient)
    out_len: torch.Tensor      # (B,) int32


def walk_init(g: gstore.DBGraph, seed_idx: torch.Tensor,
              seed_orient: torch.Tensor, max_len: int) -> WalkState:
    dev = g.device
    seed_idx = torch.as_tensor(seed_idx, device=dev).to(torch.int32)
    seed_orient = torch.as_tensor(seed_orient, device=dev).to(torch.uint8)
    B = seed_idx.shape[0]
    keys = g.keys[seed_idx.long()]
    z = torch.zeros((B,), dtype=torch.int32, device=dev)
    st = WalkState(
        idx=seed_idx, orient=seed_orient,
        okm=kops.oriented(keys, seed_orient, g.k),
        active=~sops.is_sentinel(keys),
        status=z, nsteps=z,
        brent_hash=torch.zeros((B,), dtype=torch.int64, device=dev),
        brent_steps=z, brent_limit=torch.ones_like(z),
        out_bases=torch.zeros((B, max_len), dtype=torch.uint8, device=dev),
        out_vert=torch.full((B, max_len), -1, dtype=torch.int32, device=dev),
        out_len=z)
    # the seed state is the first Brent checkpoint
    return dataclasses.replace(st, brent_hash=_state_hash(st))


def _state_hash(st: WalkState) -> torch.Tensor:
    """Walker state hash (ref graph_walker.c graph_walker_hash64): for a
    linkless walker a hash of the oriented kmer."""
    return kops.kmer_hash(st.okm)


def brent_update(st: WalkState, h: torch.Tensor, moved: torch.Tensor):
    """Brent cycle check for walkers that just moved to state hash h.
    Returns (new_state, cycle_detected)."""
    cyc = moved & (h == st.brent_hash)
    take_cp = moved & (st.brent_steps + 1 >= st.brent_limit)
    new_hash = torch.where(take_cp, h, st.brent_hash)
    new_steps = torch.where(moved, torch.where(take_cp, 0,
                                               st.brent_steps + 1),
                            st.brent_steps).to(torch.int32)
    new_limit = torch.where(take_cp, st.brent_limit * 2, st.brent_limit)
    return dataclasses.replace(st, brent_hash=new_hash,
                               brent_steps=new_steps,
                               brent_limit=new_limit), cyc


def _present(covg: torch.Tensor, j: torch.Tensor, colour: int
             ) -> torch.Tensor:
    """Coverage of rows j in `colour` is non-zero (covg holds uint32 bit
    views, so the test is != 0, not > 0)."""
    return covg[j.long(), colour] != 0


def _candidates(g: gstore.DBGraph, st: WalkState, colour: int | None,
                adj: torch.Tensor | None, uedges: torch.Tensor):
    """(pop_nib, col_nib): 4-bit masks of next bases with any-colour
    edges (uedges: the union edge byte per kmer), and of those whose next
    kmer has coverage in the walk colour.  With the adjacency each
    candidate is one gather; otherwise a batched binary search per
    base."""
    if adj is not None:
        return _candidates_at(uedges, g.covg, st.idx, st.orient, colour,
                              adj)
    pop_nib = E.with_orientation(uedges[st.idx.long()], st.orient)
    col_bits = torch.zeros_like(pop_nib)
    for n in range(4):
        nxt = kops.shift_append(st.okm, torch.full(st.idx.shape, n,
                                                   dtype=torch.int64,
                                                   device=g.device), g.k)
        key2, _ = kops.canonical(nxt, g.k)
        j, found = sops.lookup(g.keys, key2)
        incol = found if colour is None else found & _present(g.covg, j,
                                                              colour)
        col_bits = col_bits | (incol.to(torch.uint8) << n)
    return pop_nib, pop_nib & col_bits


def _candidates_at(uedges, covg, idx, orient, colour: int | None,
                   adj: torch.Tensor):
    """(pop_nib, col_nib) at explicit (idx, orient) positions through the
    adjacency (one gather per base)."""
    pop_nib = E.with_orientation(uedges[idx.long()], orient)
    col_bits = torch.zeros_like(pop_nib)
    v = idx.long() * 2 + orient.long()
    for n in range(4):
        nv = adjmod.adj_at(adj, v, n)
        found = nv >= 0
        if colour is None:
            incol = found
        else:
            incol = found & _present(covg, nv.clamp(min=0) >> 1, colour)
        col_bits = col_bits | (incol.to(torch.uint8) << n)
    return pop_nib, pop_nib & col_bits


_NIB2NUC = np.array([0, 0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0],
                    dtype=np.uint8)
_tables: dict = {}


def _table(name: str, arr: np.ndarray, dev) -> torch.Tensor:
    """A small lookup table on `dev`, copied there once (a walker step
    uses it every hop)."""
    key = (name, str(dev))
    t = _tables.get(key)
    if t is None:
        t = _tables[key] = E.table(arr, dev)
    return t


def choose_linkless(pop_nib: torch.Tensor, col_nib: torch.Tensor):
    """The linkless decision table (graph_walker.c:371-460 states 0-5).
    Returns (nuc uint8, go bool, status int32).  The JAX package's
    jnp.select takes the first true condition: the nested wheres below
    apply the conditions in reverse order, so the first one wins."""
    dev = pop_nib.device
    pop4 = _table("pop4", E.POPCOUNT4, dev)
    npop = pop4[pop_nib.long()]
    ncol = pop4[col_nib.long()]
    conds = [(npop == 0, NOCOVG),
             ((npop == 1) & (ncol == 1), COLFWD),
             ((npop == 1) & (ncol == 0), POPFWD),
             ((npop > 1) & (ncol == 1), POPFRK_COLFWD),
             ((npop > 1) & (ncol == 0), NOCOLCOVG)]
    status = torch.full(pop_nib.shape, NOLINKS, dtype=torch.int32,
                        device=dev)
    for cond, val in reversed(conds):
        status = torch.where(cond, val, status)
    # POPFWD: the single population choice is not in colour; the
    # reference takes the step (a "success" state, graph_step.h:43)
    go = (status == COLFWD) | (status == POPFRK_COLFWD) | (status == POPFWD)
    pick_nib = torch.where(status == POPFWD, pop_nib, col_nib)
    nuc = _table("nib2nuc", _NIB2NUC, dev)[pick_nib.long()]
    return nuc, go, status


def _spare(x: torch.Tensor, fill) -> torch.Tensor:
    """x (B, L) with one more column that absorbs dropped writes."""
    return torch.cat([x, torch.full(x.shape[:1] + (1,), fill, dtype=x.dtype,
                                    device=x.device)], dim=1)


def walk(g: gstore.DBGraph, st: WalkState, colour: int | None,
         max_steps: int, adj: torch.Tensor | None = None) -> WalkState:
    """Advance all walkers until they halt or take max_steps more steps
    (relative to entry)."""
    start = st.nsteps
    uedges = gstore.union_edges(g)
    B, Lmax = st.out_bases.shape
    ar = torch.arange(B, device=g.device)
    out_bases = _spare(st.out_bases, 0)
    out_vert = _spare(st.out_vert, -1)
    while bool((st.active & (st.nsteps - start < max_steps)).any()):
        pop_nib, col_nib = _candidates(g, st, colour, adj, uedges)
        nuc, go, status = choose_linkless(pop_nib, col_nib)
        adv = st.active & go
        nxt_okm = kops.shift_append(st.okm, nuc, g.k)
        if adj is not None:
            v = st.idx.long() * 2 + st.orient.long()
            nv = adjmod.adj_at(adj, v, nuc).clamp(min=0)
            j = nv >> 1
            o2 = (nv & 1).to(torch.uint8)
        else:
            key2, o2 = kops.canonical(nxt_okm, g.k)
            j, _found = sops.lookup(g.keys, key2)
        idx = torch.where(adv, j, st.idx).to(torch.int32)
        orient = torch.where(adv, o2, st.orient).to(torch.uint8)
        new_st = dataclasses.replace(
            st, okm=torch.where(adv[:, None], nxt_okm, st.okm), idx=idx,
            orient=orient)
        # cycle check on the new state (Brent)
        new_st, cyc = brent_update(new_st, _state_hash(new_st), adv)
        adv2 = adv & ~cyc
        hit_max = adv2 & (st.out_len >= Lmax)
        writes = adv2 & ~hit_max
        pos = torch.where(writes, st.out_len, Lmax).long()  # Lmax: spare
        out_bases[ar, pos] = nuc
        out_vert[ar, pos] = idx * 2 + orient.to(torch.int32)
        new_status = torch.where(
            adv, torch.where(cyc, HALT_CYCLE,
                             torch.where(hit_max, HALT_MAXLEN, status)),
            torch.where(st.active, status, st.status))
        st = dataclasses.replace(
            new_st,
            out_len=torch.where(writes, st.out_len + 1, st.out_len),
            status=new_status.to(torch.int32),
            active=st.active & go & ~cyc & ~hit_max,
            nsteps=st.nsteps + st.active.to(torch.int32))
    return dataclasses.replace(st, out_bases=out_bases[:, :Lmax],
                               out_vert=out_vert[:, :Lmax])


def walk_chunked(g, st, colour, max_steps, adj=None, chunk=512):
    """Resumable walking: repeated bounded walk() calls.  The all-halted
    check runs one chunk behind, as in the JAX package (a chunk on a
    fully halted state is a no-op)."""
    done = 0
    prev_active = None
    while done < max_steps:
        take = min(chunk, max_steps - done)
        st = walk(g, st, colour, max_steps=take, adj=adj)
        done += take
        act = bool(st.active.any())
        if prev_active is not None and not prev_active:
            break
        prev_active = act
    return st


# ---------------------------------------------------------------------------
# unitig-hop walker: junction-to-junction traversal
# ---------------------------------------------------------------------------
#
# Between junctions the linkless choice is forced, so the hop walker
# advances one whole unitig a step (graph/unitigs.py's view): the number
# of steps is the number of junctions crossed, not of bases emitted.
# Each hop records (chain end, max dist covered); re-entering a covered
# chain halts at exactly the first previously visited kmer (the
# reference's visited-set semantics, ref repeat_walker.h); Brent over
# hop-entry vertices is the backstop for walks past the visited cap.

HOPS_PER_DISPATCH = 64
HOP_CAP0 = 2048  # initial hop/visited record-buffer entries per walker


@dataclasses.dataclass
class HopState:
    v: torch.Tensor            # (B,) int32 entry vertex (not yet emitted)
    first: torch.Tensor        # (B,) bool seed hop (no junction base)
    active: torch.Tensor       # (B,) bool
    status: torch.Tensor       # (B,) int32
    out_len: torch.Tensor      # (B,) int32 bases emitted
    hop_v: torch.Tensor        # (B, H) int32 first-emitting vertex per record
    hop_n: torch.Tensor        # (B, H) int32 emit count per record
    hop_cnt: torch.Tensor      # (B,) int32
    vis_e: torch.Tensor        # (B, H) int32 visited chain-end vertices
    vis_p: torch.Tensor        # (B, H) int32 max dist covered on that chain
    vis_cnt: torch.Tensor      # (B,) int32
    brent_hash: torch.Tensor   # (B,) int64 (uint64 bits) backstop
    brent_steps: torch.Tensor  # (B,) int32
    brent_limit: torch.Tensor  # (B,) int32


def hop_init(seed_vert: torch.Tensor, alive: torch.Tensor,
             hop_cap: int) -> HopState:
    dev = seed_vert.device
    B, H = seed_vert.shape[0], hop_cap
    z = torch.zeros((B,), dtype=torch.int32, device=dev)

    def full(v):
        return torch.full((B, H), v, dtype=torch.int32, device=dev)

    return HopState(
        v=seed_vert.to(torch.int32),
        first=torch.ones((B,), dtype=torch.bool, device=dev),
        active=alive, status=z, out_len=z,
        hop_v=full(-1), hop_n=full(0), hop_cnt=z,
        vis_e=full(-2), vis_p=full(-1), vis_cnt=z,
        brent_hash=torch.zeros((B,), dtype=torch.int64, device=dev),
        brent_steps=z, brent_limit=torch.ones_like(z))


@dataclasses.dataclass
class HopGraph:
    """What a hop step reads of the graph: the store's coverage, the
    union edges, the adjacency and the unitig view's arrays."""
    covg: torch.Tensor
    uedges: torch.Tensor
    adj: torch.Tensor
    succ: torch.Tensor
    end: torch.Tensor
    dist: torch.Tensor
    is_cyc: torch.Tensor
    ulen: torch.Tensor


def _hop_block(hg: HopGraph, st: HopState, colour: int | None,
               max_len: int, nhops: int) -> HopState:
    """Advance all hop walkers up to nhops junction hops, leaving as soon
    as no walker is live (the JAX package's loop condition, read once a
    hop).  The record buffers gain a spare column for the block."""
    H = st.vis_e.shape[1]
    bufs = [_spare(st.hop_v, -1), _spare(st.hop_n, 0),
            _spare(st.vis_e, -2), _spare(st.vis_p, -1)]
    for _ in range(nhops):
        if not bool(st.active.any()):
            break
        st = _hop_step(hg, st, bufs, colour, max_len)
    hop_v, hop_n, vis_e, vis_p = (b[:, :H] for b in bufs)
    return dataclasses.replace(st, hop_v=hop_v, hop_n=hop_n, vis_e=vis_e,
                               vis_p=vis_p)


def _hop_step(hg: HopGraph, st: HopState, bufs: list, colour: int | None,
              max_len: int) -> HopState:
    """One junction hop of every walker.  bufs holds the record buffers
    (hop_v, hop_n, vis_e, vis_p), each with a spare last column that
    takes the writes the JAX package drops; they are written in place,
    and the returned state's buffer fields are left stale."""
    hop_v, hop_n, vis_e, vis_p = bufs
    B, H = st.vis_e.shape
    dev = st.v.device
    ar = torch.arange(B, device=dev)
    slot = torch.arange(H, dtype=torch.int32, device=dev)
    v = st.v.long()
    i = v >> 1
    e = hg.end[v]
    p = hg.dist[v]
    cyc_seed = st.first & hg.is_cyc[i]
    # exact visited query: the max dist already covered on this chain
    m = (vis_e[:, :H] == e[:, None]) & (slot[None, :] < st.vis_cnt[:, None])
    q = torch.where(m, vis_p[:, :H], -1).amax(dim=1)
    # a junction hop emits the junction base + the chain down to the first
    # already visited kmer (dist q) or the chain end (q = -1)
    emit = torch.where(st.first, p,
                       torch.clamp(1 + p - q.clamp(min=0), min=1))
    emit = torch.where(cyc_seed, hg.ulen[i], emit)
    room = max_len - st.out_len
    # record-buffer cap: halt rather than silently drop emission
    cap = st.hop_cnt >= H
    trunc = (emit > room) | cap
    emit_c = torch.where(cap, 0, torch.minimum(emit, room))
    fe = torch.where(st.first, hg.succ[v], st.v)
    wr = st.active & (emit_c > 0)
    pos = torch.where(wr, st.hop_cnt, H).long()     # H: the spare column
    hop_v[ar, pos] = fe
    hop_n[ar, pos] = emit_c.to(torch.int32)
    vw = st.active & (st.vis_cnt < H) & ~cyc_seed
    vpos = torch.where(vw, st.vis_cnt, H).long()
    vis_e[ar, vpos] = e
    vis_p[ar, vpos] = p
    halt_cyc = st.active & ((~st.first & (q >= 0)) | cyc_seed)
    halt_max = st.active & trunc & ~halt_cyc
    cont = st.active & ~halt_cyc & ~halt_max
    # junction choice at the chain end
    eo = (e & 1).to(torch.uint8)
    pop_nib, col_nib = _candidates_at(hg.uedges, hg.covg, e >> 1, eo, colour,
                                      hg.adj)
    nuc, go, jstatus = choose_linkless(pop_nib, col_nib)
    v2 = adjmod.adj_at(hg.adj, e, nuc)
    # Brent backstop over hop-entry vertices (uint64 arithmetic on int64
    # bits; fires only for walks past the visited cap)
    h2 = (v2.long() + 1) * kops._GOLD
    h2 = h2 ^ kops.srl(h2, 31)
    moved = cont & go
    bcyc = moved & (h2 == st.brent_hash)
    take_cp = moved & (st.brent_steps + 1 >= st.brent_limit)
    active = cont & go & ~bcyc
    status = torch.where(
        halt_max, HALT_MAXLEN,
        torch.where(halt_cyc | bcyc, HALT_CYCLE,
                    torch.where(cont, jstatus, st.status)))
    return dataclasses.replace(
        st, v=torch.where(active, v2, st.v),
        first=torch.zeros_like(st.first), active=active,
        status=status.to(torch.int32),
        out_len=(st.out_len + torch.where(st.active, emit_c, 0)
                 ).to(torch.int32),
        hop_cnt=st.hop_cnt + wr.to(torch.int32),
        vis_cnt=st.vis_cnt + vw.to(torch.int32),
        brent_hash=torch.where(take_cp, h2, st.brent_hash),
        brent_steps=torch.where(
            moved, torch.where(take_cp, 0, st.brent_steps + 1),
            st.brent_steps).to(torch.int32),
        brent_limit=torch.where(take_cp, st.brent_limit * 2,
                                st.brent_limit))


_chars = Memo()


def cached_emit_chars(keys: torch.Tensor, k: int) -> np.ndarray:
    """Host copy of _emit_chars, memoised on the key tensor (CLI contigs
    reconstructs every seed batch against one store)."""
    return _chars.get((keys,), lambda: _emit_chars(keys, k).cpu().numpy())


def _emit_chars(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(2N,) uint8: the base emitted on arrival at each vertex (the last
    nucleotide of the oriented kmer)."""
    out = torch.empty((2 * keys.shape[0],), dtype=torch.uint8,
                      device=keys.device)
    out[0::2] = (keys[:, -1] & 3).to(torch.uint8)
    out[1::2] = 3 - kops.first_base(keys, k)
    return out


def hop_walk(g, uv, seed_vert: torch.Tensor, colour: int | None,
             max_len: int, adj, uedges, hop_cap: int | None = None):
    """Run the hop walker to completion.

    The hop/visited record buffers start at HOP_CAP0 entries; if any
    walker halts on the buffer cap short of max_len, the whole batch is
    run again with the cap grown 4x (cap halts leave out_len < max_len;
    genuine max_len halts fill it), so no contig is silently shortened."""
    grow = hop_cap is None
    if hop_cap is None:
        hop_cap = min(HOP_CAP0, max_len + 2)
    while True:
        st = _hop_walk_once(g, uv, seed_vert, colour, max_len, adj,
                            uedges, hop_cap)
        if not grow or hop_cap >= max_len + 2:
            return st
        trunc = ((st.status == HALT_MAXLEN) & (st.out_len < max_len)
                 & (st.hop_cnt >= hop_cap))
        if not bool(trunc.any()):
            return st
        hop_cap = min(hop_cap * 4, max_len + 2)


def _hop_walk_once(g, uv, seed_vert, colour, max_len, adj, uedges,
                   hop_cap):
    alive = ~sops.is_sentinel(g.keys[seed_vert.long() >> 1])
    st = hop_init(seed_vert, alive, hop_cap)
    hg = HopGraph(covg=g.covg, uedges=uedges, adj=adj, succ=uv.succ,
                  end=uv.end, dist=uv.dist, is_cyc=uv.is_cycle,
                  ulen=uv.length)
    # every continuing hop emits >= 1 base, so max_len bounds the hops
    max_iters = max_len + 2
    done = 0
    while done < max_iters and bool(st.active.any()):
        take = min(HOPS_PER_DISPATCH, max_iters - done)
        st = _hop_block(hg, st, colour, max_len, take)
        done += take
    return st


_layouts = Memo()


def _chain_layout(uv, chars_np):
    """Walk-order layout (vertices sorted by (end, -dist)) + chars,
    memoised per unitig view (on its succ tensor)."""
    return _layouts.get((uv.succ,), lambda: _make_layout(uv, chars_np))


def _make_layout(uv, chars_np):
    end = uv.end.cpu().numpy()
    dist = uv.dist.cpu().numpy()
    order = np.lexsort((-dist, end))
    return (end, dist, uv.is_cycle.cpu().numpy(), order, chars_np[order],
            np.searchsorted(end[order], np.arange(end.shape[0])))


def _reconstruct_hops(uv, chars_np, hop_v, hop_n, hop_cnt):
    """Host assembly of emitted base runs from hop records (numpy).

    Chain hops are slices of a per-chain walk-order layout (vertices
    sorted by (end, -dist)); cycle hops follow succ directly."""
    succ = None
    end, dist, is_cyc, order, sorted_chars, run_start = \
        _chain_layout(uv, chars_np)
    out = []
    for b in range(hop_v.shape[0]):
        parts = []
        for h in range(int(hop_cnt[b])):
            fe, cnt = int(hop_v[b, h]), int(hop_n[b, h])
            if fe < 0 or cnt <= 0:
                continue
            if is_cyc[fe >> 1]:
                if succ is None:
                    succ = uv.succ.cpu().numpy()
                vcur, buf = fe, []
                for _ in range(cnt):
                    buf.append(chars_np[vcur])
                    vcur = succ[vcur]
                parts.append(np.asarray(buf, np.uint8))
                continue
            base = run_start[end[fe]]
            i0 = base + (dist[order[base]] - dist[fe])
            parts.append(sorted_chars[i0:i0 + cnt])
        out.append(np.concatenate(parts) if parts
                   else np.zeros((0,), np.uint8))
    return out


def _seed_strings(g: gstore.DBGraph, seed_rows: np.ndarray) -> list:
    keys = g.keys[torch.as_tensor(seed_rows, device=g.device).long()]
    return kmers_to_strings(keys.cpu().numpy().view(np.uint64), g.k)


def assemble_linkless_contigs(g: gstore.DBGraph, seed_rows: np.ndarray,
                              colour: int | None = 0,
                              max_len: int = 4096, devices=None):
    """A contig for each seed row by unitig hops: walk right from (seed,
    FORWARD) and left from (seed, REVERSE), join (ref
    assemble_contigs.c:88-119 without links/confidence).  Returns
    (contigs: list[str], stop_status: (B, 2) right/left halt codes).

    devices: a list of devices for the data-parallel mode (the JAX
    package's walk_dp mesh): a replica of the graph on each device, with
    its own unitig view, adjacency and lookup table; the seeds split into
    contiguous chunks, each walked on its device; the contigs joined in
    seed order."""
    from . import unitigs as U
    B = len(seed_rows)
    if B == 0:
        return [], np.zeros((0, 2), np.int32)
    if devices is not None and len(devices) > 1:
        from ..parallel import shard as psh
        contigs, stats = [], []
        for dev, (s0, s1) in zip(devices, psh.chunks(B, len(devices))):
            if s1 > s0:
                with psh.on(dev):
                    c, st = assemble_linkless_contigs(
                        psh.replica(g, dev), seed_rows[s0:s1], colour,
                        max_len)
                contigs += c
                stats.append(st)
        return contigs, np.concatenate(stats)
    seed_rows = np.asarray(seed_rows, np.int64)
    seeds = torch.from_numpy(seed_rows).to(g.device, torch.int32)
    adj = adjmod.get_adjacency(g)
    uedges = gstore.cached_union_edges(g)
    uv = U.cached_unitig_view(g.keys, uedges, g.k)
    with span("layout"):
        chars_np = cached_emit_chars(g.keys, g.k)
        _chain_layout(uv, chars_np)
    halves, stats = [], []
    for o in (0, 1):
        with span("hops", g.device):
            st = hop_walk(g, uv, seeds * 2 + o, colour, max_len, adj,
                          uedges)
            # only the records written are read back
            h = max(int(st.hop_cnt.max()), 1)
            hop_v, hop_n = st.hop_v[:, :h].cpu(), st.hop_n[:, :h].cpu()
        with span("reconstruct"):
            halves.append(_reconstruct_hops(
                uv, chars_np, hop_v.numpy(), hop_n.numpy(),
                st.hop_cnt.cpu().numpy()))
        stats.append(st.status.cpu().numpy())
    seed_strs = _seed_strings(g, seed_rows)
    contigs = []
    for i in range(B):
        right = _CHARS[halves[0][i]].tobytes().decode()
        left = _CHARS[3 - halves[1][i][::-1]].tobytes().decode()
        contigs.append(left + seed_strs[i] + right)
    return contigs, np.stack(stats, axis=1)


def assemble_linkless_contigs_steps(g: gstore.DBGraph,
                                    seed_rows: np.ndarray,
                                    colour: int | None = 0,
                                    max_len: int = 4096):
    """The same contigs by the kmer walker, one base a step.  Returns
    (contigs: list[str], stop_status: (B, 2) right/left halt codes) in
    seed order."""
    B = len(seed_rows)
    if B == 0:
        return [], np.zeros((0, 2), np.int32)
    seed_rows = np.asarray(seed_rows, np.int64)
    seeds = torch.from_numpy(seed_rows).to(g.device, torch.int32)
    adj = adjmod.get_adjacency(g)
    halves, stats = [], []
    for o in (0, 1):
        st = walk_init(g, seeds, torch.full((B,), o, dtype=torch.uint8),
                       max_len)
        st = walk_chunked(g, st, colour, max_len + 1, adj=adj)
        halves.append((st.out_bases.cpu().numpy(), st.out_len.cpu().numpy()))
        stats.append(st.status.cpu().numpy())
    seed_strs = _seed_strings(g, seed_rows)
    (fw_b, fw_l), (rv_b, rv_l) = halves
    contigs = []
    for i in range(B):
        right = _CHARS[fw_b[i, :fw_l[i]]].tobytes().decode()
        left = _CHARS[3 - rv_b[i, :rv_l[i]][::-1]].tobytes().decode()
        contigs.append(left + seed_strs[i] + right)
    return contigs, np.stack(stats, axis=1)

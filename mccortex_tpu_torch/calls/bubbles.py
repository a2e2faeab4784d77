"""Bubble caller: reference-free variant calling across colours;
counterpart of mccortex_tpu/calls/bubbles.py.

Role of ref src/tools/bubble_caller.c: at every fork (union out-degree
> 1 in either orientation), walk each in-colour branch per colour (with
links if provided) up to max_allele_len; bubbles are groups of >= 2
distinct branch paths (deduped across colours) that converge on a shared
downstream unitig; emit 5' flank (backward unitig extension from the
fork), branch alleles, and the shared 3' flank unitig.  Filters: haploid
repeat filter (a haploid colour may support at most one branch,
remove_haploid_paths) and serial-bubble suppression.

All (fork, branch, colour) walks run as one batched linked walk a colour
on the store's device (links/walk.walk_linked over the adjacency, whose
lookups are the lookup kernel on the card); convergence and grouping run
per fork on the host over the recorded vertex paths, as in the JAX
package, in the same order.  With a list of devices (the JAX package's
`mesh`), each colour's walkers are split over them, each device holding
a replica of the graph and the links, and the walked states are joined
in walker order.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from ..graph import adjacency as adjmod
from ..graph import edges as E
from ..graph import store as gstore
from ..graph import traverse as T
from ..graph import unitigs as U
from ..links import store as lstore
from ..links import walk as lwalk
from ..ops import kmer as kops
from ..ops import sorted as sops
from ..utils.text import kmers_to_strings

_CHARS = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Bubble:
    fork_vertex: int
    flank5p: str       # ends with the fork kmer
    flank3p: str       # shared unitig bases (per-node last nuc)
    branches: list     # [(allele_bases_str, colour_set)]
    branch_colsets: list


def find_fork_vertices(g: gstore.DBGraph) -> np.ndarray:
    """All vertices (2*row+orient) with union out-degree > 1
    (ref bubble_caller_node)."""
    n = int(g.n)
    uedges = gstore.union_edges(g)[:n].cpu().numpy()
    pop = E.POPCOUNT4
    fw = pop[uedges & 0xF] > 1
    rv = pop[(uedges >> 4) & 0xF] > 1
    verts = np.concatenate([2 * np.nonzero(fw)[0], 2 * np.nonzero(rv)[0] + 1])
    return np.sort(verts)


def _next_rows(g: gstore.DBGraph, okm: torch.Tensor, n: int):
    """(row, found) of each oriented kmer's successor by base n, by binary
    search (ops/sorted.lookup: the insertion point where not found)."""
    nxt = kops.shift_append(okm, torch.full(okm.shape[:1], n,
                                            dtype=torch.int64,
                                            device=okm.device), g.k)
    key2, _ = kops.canonical(nxt, g.k)
    return sops.lookup(g.keys, key2)


def _branch_walks(g, links, fork_verts, max_allele, ncols, devices=None):
    """Launch walks for every (fork, branch, colour).  Returns
    (meta (B, 3) = fork index, branch nucleotide, colour; [(walker
    indices, walked state)] one a colour; B), or [] with no walker.
    devices: each colour's walkers split into contiguous chunks over
    these devices (replicas of the graph and links), the states joined
    on the graph's device in walker order."""
    F = len(fork_verts)
    C = ncols
    dev = g.device
    rows = fork_verts >> 1
    orients = fork_verts & 1
    uedges = gstore.union_edges(g).cpu().numpy()[rows]
    # out-nibble when traversing orientation o
    nib = ((uedges >> (4 * orients)) & 0xF).astype(np.uint8)
    covg_np = g.covg.cpu().numpy()

    # branch-node colour presence (ref find_bubbles node_has_col): only
    # walk branch b in colour c if both the fork node and the branch's
    # first node are present in c
    fork_okm = kops.oriented(g.keys[torch.from_numpy(rows).to(dev)],
                             torch.from_numpy(orients.astype(np.uint8)
                                              ).to(dev), g.k)
    branch_has_col = np.zeros((F, 4, C), bool)
    for n in range(4):
        jrow, found = _next_rows(g, fork_okm, n)
        pres = covg_np[jrow.cpu().numpy()] != 0   # (F, C)
        branch_has_col[:, n, :] = pres & found.cpu().numpy()[:, None]
    fork_has_col = covg_np[rows] != 0  # (F, C)

    # one walker per (fork, branch nuc, colour), in that order (np.nonzero
    # of a C-order array is lexicographic)
    has_nuc = ((nib[:, None] >> np.arange(4, dtype=np.uint8)) & 1) > 0
    want = has_nuc[:, :, None] & fork_has_col[:, None, :] & branch_has_col
    meta = np.stack(np.nonzero(want), axis=1)
    if len(meta) == 0:
        return []
    B = len(meta)
    seed_rows = rows[meta[:, 0]]
    seed_orients = orients[meta[:, 0]]

    st = lwalk.linked_init(
        g, links, torch.from_numpy(seed_rows.astype(np.int32)).to(dev),
        torch.from_numpy(seed_orients.astype(np.uint8)).to(dev), max_allele)
    # force the first step to the branch nucleotide
    st = _force_first_step(
        g, links, st, torch.from_numpy(meta[:, 1].astype(np.uint8)).to(dev),
        torch.from_numpy(meta[:, 2].astype(np.int64)).to(dev))
    # one walk per colour, so that the walk colour is one value
    out = []
    for c in range(C):
        sel = np.nonzero(meta[:, 2] == c)[0]
        if len(sel) == 0:
            continue
        sub = _walk_split(g, links, _take_walkers(st, sel), c, max_allele,
                          devices or [dev])
        lwalk.report_drops(sub, "bubbles")
        out.append((sel, sub))
    return meta, out, B


def _walk_split(g, links, st, c, max_allele, devices):
    """One colour's linked walk, its walkers split into contiguous chunks
    over `devices`, each walked on a replica of the graph and links;
    the states joined on the graph's device."""
    from ..parallel import shard as psh
    parts = []
    for d, (s0, s1) in zip(devices, psh.chunks(st.cur_link.shape[0],
                                                len(devices))):
        if s1 <= s0:
            continue
        with psh.on(d):
            gd, ld = psh.replica(g, d), psh.replica(links, d)
            sub = psh.to_device(_take_walkers(st, np.arange(s0, s1)), d)
            parts.append(lwalk.walk_linked(
                gd, ld, sub, c, max_steps=max_allele,
                ctpcol=min(c, links.nseen.shape[1] - 1),
                adj=adjmod.get_adjacency(gd),    # one gather a step
                hopinfo=lwalk.get_hopinfo(gd, ld)))
    if len(parts) == 1:
        return psh.to_device(parts[0], g.device)
    return psh.concat(parts, g.device, shared=("used",))


def _take_walkers(st: lwalk.LinkedWalkState, sel) -> lwalk.LinkedWalkState:
    """The walkers `sel` of a state: every per-walker field indexed.
    `used` is per link, not per walker, and stays as it is (the JAX
    package's tree_map indexes it too; the calling walks never read it:
    they do not track used links)."""
    idx = torch.as_tensor(np.asarray(sel), dtype=torch.int64,
                          device=st.cur_link.device)
    base = T.WalkState(**{
        f.name: getattr(st.base, f.name)[idx]
        for f in dataclasses.fields(T.WalkState)})
    return lwalk.LinkedWalkState(base=base, **{
        f.name: (getattr(st, f.name) if f.name == "used"
                 else getattr(st, f.name)[idx])
        for f in dataclasses.fields(lwalk.LinkedWalkState)
        if f.name != "base"})


def _force_first_step(g, links, st: lwalk.LinkedWalkState, nuc, colours):
    """Take the forced branch step (ref graph_walker_force at the fork:
    cursor bases consumed iff the fork is a fork in the walk colour).
    nuc (B,) uint8, colours (B,) int64 tensors on the store's device."""
    b = st.base
    B = b.idx.shape[0]
    dev = b.idx.device
    # is the fork a fork in each walker's colour? (#next in colour > 1)
    fork_nib = E.with_orientation(gstore.union_edges(g)[b.idx.long()],
                                  b.orient)
    incol_count = torch.zeros((B,), dtype=torch.int32, device=dev)
    for n in range(4):
        j, found = _next_rows(g, b.okm, n)
        present = found & (g.covg[j.long(), colours.long()] != 0)
        # the branch edge must exist at all
        has_edge = ((fork_nib >> n) & 1).bool()
        incol_count += (present & has_edge).to(torch.int32)
    is_fork = incol_count > 1

    lost_nuc = kops.first_base(b.okm, g.k)
    nxt_okm = kops.shift_append(b.okm, nuc, g.k)
    key2, o2 = kops.canonical(nxt_okm, g.k)
    j, found = sops.lookup(g.keys, key2)
    nb = dataclasses.replace(b, okm=nxt_okm, idx=j.to(torch.int32),
                             orient=o2.to(torch.uint8),
                             active=b.active & found)
    # cursor consumption
    bases = lwalk._cursor_bases(links, st)
    live = st.cur_link >= 0
    match = bases == nuc[:, None]
    exhausted = st.cur_pos + 1 >= lwalk._nj_of(links, st.cur_link)
    fk = is_fork[:, None]
    keep = live & (~fk | (match & ~exhausted))
    cur_pos = torch.where(fk & keep, st.cur_pos + 1, st.cur_pos)
    cur_link = torch.where(keep, st.cur_link, -1)
    rv_fork = lwalk._other_prev_exists(g, nb, lost_nuc, 0) & nb.active
    bump = (is_fork & nb.active) | rv_fork
    cur_age = torch.where(bump[:, None] & (cur_link >= 0),
                          st.cur_age + 1, st.cur_age)
    # record the first step output
    out_bases = nb.out_bases.clone()
    out_bases[:, 0] = nuc
    out_vert = nb.out_vert.clone()
    out_vert[:, 0] = nb.idx * 2 + nb.orient.to(torch.int32)
    out_len = nb.active.to(torch.int32)
    nb = dataclasses.replace(nb, out_bases=out_bases, out_vert=out_vert,
                             out_len=out_len)
    st2 = st.replace(base=nb, cur_link=cur_link, cur_pos=cur_pos,
                     cur_age=cur_age)
    st2 = lwalk._pickup(links, st2, 0)
    return st2.replace(base=dataclasses.replace(
        st2.base, brent_hash=lwalk._linked_hash(st2)))


def unitig_chain(g, start_vertex, succ, max_len):
    """Vertices of the unitig starting at start_vertex (inclusive)."""
    out = [start_vertex]
    v = int(succ[start_vertex])
    while v >= 0 and len(out) < max_len and v != start_vertex:
        out.append(v)
        v = int(succ[v])
    return out


def call_bubbles(g: gstore.DBGraph, links: lstore.LinkStore | None = None,
                 max_allele: int = 300, max_flank: int = 1000,
                 haploid_cols=(), remove_serial: bool = True,
                 devices=None):
    """Find all bubbles.  Returns list[Bubble].

    Matches the reference's per-shared-unitig enumeration
    (ref bubble_caller.c:425 find_bubbles_ending_with): each fork can
    yield MULTIPLE (nested) bubbles — one per downstream unitig that >=2
    branch paths enter the same way — after the reference filter chain
    (is_3p_flank, dupe removal, haploid filter, serial suppression).
    remove_serial defaults True as in ctx_bubbles.c (-S keeps them).
    """
    ncols = g.ncols
    if links is None:
        links = lstore.empty(g.capacity, ncols, device=g.device)
    fork_verts = find_fork_vertices(g)
    if len(fork_verts) == 0:
        return []
    res = _branch_walks(g, links, fork_verts, max_allele, ncols, devices)
    if not res:
        return []
    meta, walks, B = res
    # gather per-walker outputs (fill interior-hop gaps from the layout)
    verts = np.full((B, max_allele), -1, np.int32)
    bases = np.zeros((B, max_allele), np.uint8)
    lens = np.zeros(B, np.int32)
    for sel, sub in walks:
        # prefix-width returns (live pow2 bucket, not the full buffer)
        ob, ov = lwalk.fill_hop_outputs(g, sub)
        wv = min(ov.shape[1], verts.shape[1])
        wb = min(ob.shape[1], bases.shape[1])
        verts[sel[:, None], np.arange(wv)] = ov[:, :wv]
        bases[sel[:, None], np.arange(wb)] = ob[:, :wb]
        lens[sel] = sub.base.out_len.cpu().numpy()

    view = U.unitig_view(g.keys, gstore.union_edges(g), g.k)
    succ = view.succ.cpu().numpy()
    uid_np = view.uid.cpu().numpy()
    keys_np = g.keys.cpu().numpy().view(np.uint64)

    # meta is sorted by fork: each fork's walkers are one run of it
    bounds = np.searchsorted(meta[:, 0], np.arange(len(fork_verts) + 1))
    bubbles = []
    for fi in range(len(fork_verts)):
        wsel = np.arange(bounds[fi], bounds[fi + 1])
        if len(wsel) < 2:
            continue
        paths = []
        for w in wsel:
            if lens[w] == 0:
                continue
            paths.append((int(meta[w, 1]), int(meta[w, 2]),
                          verts[w, :lens[w]], bases[w, :lens[w]]))
        if len(paths) < 2:
            continue
        bubbles.extend(_fork_bubbles(
            g, fork_verts[fi], paths, uid_np, succ, haploid_cols,
            max_allele, max_flank, keys_np, remove_serial))
    return bubbles


def _fork_bubbles(g, fork_vertex, paths, uid_np, succ, haploid_cols,
                  max_allele, max_flank, keys_np, remove_serial=True):
    """All bubbles from one fork's branch paths (host Python, a copy of
    the JAX package's: the iteration orders fix the call file's order).

    Each path is decomposed into unitig STEPS; a step's identity is its
    entry vertex (entries into a unitig in a given direction always land
    on the same head vertex, since unitigs break at degree changes — the
    role of ref GCacheStep's (unitig, orient) encoding).  Every step
    word with >= 2 steps across paths is a candidate 3' flank, filtered
    exactly as ref filter_bubbles (bubble_caller.c:387-421):
      1. is_3p_flank (graph_cache.c:337): first steps not all equal AND
         some second-last step differs;
      2. duplicate step-prefix removal (colours of dropped duplicates
         merge into the survivor — the reference loses them to qsort
         dedupe, a deliberate improvement);
      3. haploid-repeat path removal (remove_haploid_paths);
      4. serial suppression: drop if some unitig occurs in every kept
         step's strict prefix (paths_all_share_unitig).
    """
    # unitig-step decomposition per path: (entry vertex, kmer position)
    path_steps = []
    for (_br, _c, vs, _bs) in paths:
        u = uid_np[vs >> 1]
        bnd = np.ones(len(vs), bool)
        bnd[1:] = u[1:] != u[:-1]
        pos = np.nonzero(bnd)[0]
        path_steps.append([(int(vs[i]), int(i)) for i in pos])

    groups = defaultdict(list)   # entry vertex -> [(path, step index)]
    order = []
    for p, steps in enumerate(path_steps):
        for si, (w, _pos) in enumerate(steps):
            if w not in groups:
                order.append(w)
            groups[w].append((p, si))

    bubbles = []
    for w in order:
        steps = groups[w]
        if len(steps) < 2:
            continue
        # 1. is_3p_flank
        firsts = {path_steps[p][0][0] for p, _si in steps}
        if len(firsts) < 2:
            continue
        prevs = [path_steps[p][si - 1][0] if si > 0 else None
                 for p, si in steps]
        if prevs[0] is None:
            if not any(x is not None for x in prevs[1:]):
                continue
        else:
            if not any(x is None or x != prevs[0] for x in prevs[1:]):
                continue
        # 2. dedupe on the step prefix (inclusive); merge colours
        seen = {}
        for p, si in steps:
            key = tuple(x for x, _ in path_steps[p][:si + 1])
            if key in seen:
                seen[key][1].add(paths[p][1])
            else:
                seen[key] = ((p, si), {paths[p][1]})
        items = [v for _k, v in sorted(seen.items())]
        if len(items) < 2:
            continue
        # 3. haploid filter
        hap_seen = set()
        kept = []
        for (p, si), cols in items:
            drop = False
            for h in haploid_cols:
                if h in cols:
                    if h in hap_seen:
                        drop = True
                        break
                    hap_seen.add(h)
            if not drop:
                kept.append(((p, si), cols))
        if len(kept) < 2:
            continue
        # 4. serial suppression
        if remove_serial:
            cnt = defaultdict(int)
            for (p, si), _cols in kept:
                for x, _pos in path_steps[p][:si]:
                    cnt[x] += 1
            if any(v == len(kept) for v in cnt.values()):
                continue

        branches, colsets = [], []
        for (p, si), cols in kept:
            cutpos = path_steps[p][si][1]
            bs = paths[p][3]
            branches.append(_CHARS[bs[:cutpos]].tobytes().decode())
            colsets.append(sorted(cols))
        chain = unitig_chain(g, w, succ, max_allele)
        flank3p = _verts_to_bases(g, chain, keys_np)
        fchain = unitig_chain(g, fork_vertex ^ 1, succ, max_flank)
        flank5p = _flank5p_seq(g, fchain, keys_np)
        bubbles.append(Bubble(fork_vertex=int(fork_vertex),
                              flank5p=flank5p, flank3p=flank3p,
                              branches=branches,
                              branch_colsets=colsets))
    return bubbles


def _oriented_rows(g, verts, keys_np) -> np.ndarray:
    """Oriented kmers (n, W) uint64 of vertices 2*row+orient, on the
    host (graph/unitigs._oriented_np)."""
    v = np.asarray(verts, np.int64)
    return U._oriented_np(keys_np[v >> 1], (v & 1).astype(np.uint8), g.k)


def _vertex_kmer(g, v, keys_np):
    return kmers_to_strings(_oriented_rows(g, [v], keys_np), g.k)[0]


def _verts_to_bases(g, chain, keys_np):
    """Per-vertex last base of the oriented kmer along a chain."""
    if not chain:
        return ""
    okm = _oriented_rows(g, chain, keys_np)
    return _CHARS[(okm[:, -1] & np.uint64(3)).astype(np.uint8)
                  ].tobytes().decode()


def _flank5p_seq(g, fchain, keys_np):
    """5' flank: nodes of the backward chain reverse-complemented so the
    sequence ends at (and includes) the fork kmer; printed as first kmer
    + last bases (ref branch_to_str with print_first_kmer=True)."""
    rev_chain = [v ^ 1 for v in reversed(fchain)]
    first = _vertex_kmer(g, rev_chain[0], keys_np)
    rest = _verts_to_bases(g, rev_chain[1:], keys_np)
    return first + rest

"""Link cleaning and inspection as junction trees; counterpart of
mccortex_tpu/links/link_tree.py (role of ref src/paths/link_tree.{c,h}
and src/commands/ctx_links.c).

Each kmer's links form a 4-ary junction tree whose edges carry coverage
(the summed nseen of every link through that junction choice) and a
distance (kmers from the root kmer):

  - clean:      truncate every link at its first junction edge with
                coverage < cutoff; the emitted links are the maximal
                surviving paths (ref _ltree_clean_link, prefix
                suppression in _ltree_write_ctp_link);
  - list:       (SeqLen, Covg) of every surviving edge;
  - covg-hist:  dist x covg matrix over the unique edges;
  - threshold:  the kmer-cleaning threshold picker per distance, the
                median suggested as the cutoff;
  - plot:       DOT of one kmer's tree.

Junction distances come from one batched trace of every link on g's
device (a host loop over the JAX package's `lax.while_loop` body that
reads the live count once a step; the walkers' next vertex through the
adjacency, which the lookup kernel builds on a CUDA store).  Writes that
JAX drops with `mode="drop"` go to one spare column, sliced off.  The
tree itself is host numpy: edge identities are prefix groups of the
(vertex, junction bases) sort order, so the per-depth counts are
segment sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import adjacency as adjmod
from ..graph import edges as E
from ..graph import store as gstore
from ..graph import traverse as T
from ..utils.text import kmers_to_strings
from . import store as lstore
from . import walk as lwalk

_BASECHARS = "ACGT"


def unpack_bases(seq: np.ndarray, nj: np.ndarray) -> np.ndarray:
    """Packed (L, JW) uint64 -> (L, Jmax) uint8 base codes, zero beyond
    nj (the inverse of lstore.pack_juncs)."""
    L = seq.shape[0]
    jmax = int(nj.max()) if L else 1
    out = np.zeros((L, max(jmax, 1)), np.uint8)
    for p in range(jmax):
        w = p // 32
        sh = np.uint64(62 - 2 * (p % 32))
        out[:, p] = ((seq[:, w] >> sh) & np.uint64(3)).astype(np.uint8)
    mask = np.arange(out.shape[1])[None, :] < nj[:, None]
    return out * mask


def _trace(g: gstore.DBGraph, links: lstore.LinkStore,
           start_vert: torch.Tensor, link_ids: torch.Tensor,
           edge_colour: int, max_steps: int, jcap: int,
           record_bases: bool, adj: torch.Tensor):
    """Walk each link's junction path from its vertex through g's
    adjacency `adj` (adjacency.get_adjacency); record the node index
    (= kmer distance from the root) of every junction, and the bases
    taken when record_bases (ref gpath_fetch, gpath_checks.c:199-234).
    Returns (jpos (B, jcap) int32 padded -1, ok (B,) bool,
    bases (B, max_steps) or (B, 1) uint8, len (B,) int32)."""
    B = start_vert.shape[0]
    dev = g.device
    ar = torch.arange(B, device=dev)
    pop4 = T._table("pop4", E.POPCOUNT4, dev)
    nib2nuc = T._table("nib2nuc", T._NIB2NUC, dev)
    start_vert = start_vert.to(dev).long()
    link_ids = link_ids.to(dev).long()
    idx = (start_vert >> 1).to(torch.int32)
    orient = (start_vert & 1).to(torch.uint8)
    if links.nlinks:
        nj = links.nj[link_ids]
        rows = links.seq[link_ids.clamp(0, links.nlinks - 1)]
    else:
        nj = torch.zeros((B,), dtype=torch.int32, device=dev)
        rows = None
    pos = torch.zeros((B,), dtype=nj.dtype, device=dev)
    ln = torch.zeros((B,), dtype=torch.int32, device=dev)
    jpos = torch.full((B, jcap + 1), -1, dtype=torch.int32, device=dev)
    bases = torch.zeros((B, max_steps + 1 if record_bases else 1),
                        dtype=torch.uint8, device=dev)
    active = nj > 0
    ok = torch.ones((B,), dtype=torch.bool, device=dev)
    done = nj <= 0
    while bool(active.any()):
        nib = E.with_orientation(g.edges[idx.long(), edge_colour], orient)
        outdeg = pop4[nib.long()]
        at_fork = outdeg > 1
        jb = (lstore.unpack_junc(rows, pos) if rows is not None
              else torch.zeros((B,), dtype=torch.uint8, device=dev))
        # the single edge's base (read only where the out-degree is 1)
        nuc = torch.where(at_fork, jb, nib2nuc[nib.long()]).to(torch.uint8)
        has_edge = ((nib >> nuc) & 1).bool()
        adv = active & (outdeg > 0) & has_edge
        rec = adv & at_fork
        # the junction's position = the current node's index (jcap: spare)
        jpos[ar, torch.where(rec, pos.long(), jcap)] = ln
        nv = adjmod.adj_at(adj, idx.long() * 2 + orient.long(),
                           nuc).clamp(min=0)
        j = nv >> 1
        o2 = (nv & 1).to(torch.uint8)
        pos2 = torch.where(rec, pos + 1, pos)
        if record_bases:
            bases[ar, torch.where(adv, ln.long(), max_steps)] = nuc
        ln2 = torch.where(adv, ln + 1, ln)
        fin = pos2 >= nj
        ok = ok & ~(active & ~adv)
        done = done | (adv & fin)
        idx = torch.where(adv, j, idx).to(torch.int32)
        orient = torch.where(adv, o2, orient).to(torch.uint8)
        pos, ln = pos2, ln2
        active = adv & ~fin & (ln2 < max_steps)
    bases = bases[:, :max_steps] if record_bases else bases
    return jpos[:, :jcap], ok & done, bases, ln


def trace_juncpos(g: gstore.DBGraph, links: lstore.LinkStore,
                  edge_colour: int = 0, max_steps: int = 1024,
                  record_bases: bool = False, chunk: int = 1 << 17):
    """Junction node-distances of every link (batched trace on g's
    device, `chunk` links a trace).

    Returns (jpos (L, Jmax) int32 padded -1, ok (L,) bool, bases (L,
    max_steps) uint8 or None, blen (L,) int32).  ok is the reference's
    walkability condition (gpath_checks.c): every junction consumed at a
    real fork with a matching edge."""
    L = links.nlinks
    nj = links.nj.cpu().numpy()
    jcap = max(int(nj.max()) if L else 1, 1)
    if L == 0:
        return (np.zeros((0, jcap), np.int32), np.zeros((0,), bool),
                np.zeros((0, max_steps), np.uint8) if record_bases else None,
                np.zeros((0,), np.int32))
    adj = adjmod.get_adjacency(g)
    lv = lwalk.link_vertices(links, g.capacity)
    jp_out = np.empty((L, jcap), np.int32)
    ok_out = np.empty((L,), bool)
    b_out = np.empty((L, max_steps), np.uint8) if record_bases else None
    bl_out = np.empty((L,), np.int32)
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        jp, ok, bases, blen = _trace(
            g, links, torch.from_numpy(lv[s:e]),
            torch.arange(s, e), edge_colour, max_steps, jcap,
            record_bases, adj)
        jp_out[s:e] = jp.cpu().numpy()
        ok_out[s:e] = ok.cpu().numpy()
        if record_bases:
            b_out[s:e] = bases.cpu().numpy()
        bl_out[s:e] = blen.cpu().numpy()
    return jp_out, ok_out, b_out, bl_out


class LinkTreeView:
    """Junction-tree view of a whole single-colour link set (host numpy).

    Arrays are in a canonical sort order (vertex, junction bases); tree
    edges at depth j are contiguous groups of rows sharing the first
    j+1 junction bases.  `counts[:, j]` is the coverage of the link's
    j-th junction edge (sum of nseen over the group), `rep[:, j]` marks
    one representative row per unique edge.
    """

    def __init__(self, g: gstore.DBGraph, links: lstore.LinkStore,
                 jpos: np.ndarray | None = None):
        L = links.nlinks
        self.g = g
        self.links = links
        _offs, seq, nj, nseen = lstore.to_host(links)
        nj = nj.astype(np.int64)
        if nseen.shape[1] != 1:
            # a multi-colour store whose counts live in ONE colour (a
            # per-sample file saved against a multi-colour graph) is
            # single-colour in effect: use that column
            used = np.nonzero(nseen.sum(axis=0) > 0)[0]
            if len(used) > 1:
                raise ValueError(
                    "link cleaning requires a single-colour .ctp "
                    "(ref ctx_links.c: 'Can only clean a single "
                    "colour at a time')")
            col = int(used[0]) if len(used) else 0
            self.colour = col
            self.ncols = nseen.shape[1]
            nseen = nseen[:, col:col + 1]
        else:
            self.colour = 0
            self.ncols = 1
        verts = lwalk.link_vertices(links, g.capacity).astype(np.int64)
        bases = unpack_bases(seq, nj)
        Jmax = bases.shape[1]
        order = np.lexsort(tuple(bases[:, j] for j in range(Jmax - 1, -1, -1))
                           + (verts,))
        self.order = order
        self.verts = verts[order]
        self.nj = nj[order]
        self.bases = bases[order]
        self.w = nseen[order, 0].astype(np.uint64)
        self.jpos = jpos[order] if jpos is not None else None
        self.Jmax = Jmax
        self.L = L

        # per-depth prefix grouping: boundary_j = boundary_{j-1} OR base
        # j differs between consecutive rows
        counts = np.zeros((L, Jmax), np.uint64)
        rep = np.zeros((L, Jmax), bool)
        gid = np.zeros((L, Jmax), np.int64)
        if L:
            ng = self.verts[1:] != self.verts[:-1]
            for j in range(Jmax):
                ng = ng | (self.bases[1:, j] != self.bases[:-1, j])
                bj = np.concatenate([[True], ng])
                gj = np.cumsum(bj) - 1
                gid[:, j] = gj
                active = self.nj > j
                cnt = np.zeros(gj[-1] + 1, np.uint64)
                np.add.at(cnt, gj[active], self.w[active])
                counts[:, j] = np.where(active, cnt[gj], 0)
                ai = np.nonzero(active)[0]
                if len(ai):
                    ga = gj[ai]
                    firsts = np.concatenate([[True], ga[1:] != ga[:-1]])
                    rep[ai[firsts], j] = True
        self.counts = counts
        self.rep = rep
        self.gid = gid

    # -- cleaning ----------------------------------------------------

    def keep_lengths(self, cutoff: int) -> np.ndarray:
        """Per (sorted) link: junctions kept = the first j whose edge
        count is below cutoff (ref _ltree_clean_link truncates from the
        root down)."""
        active = np.arange(self.Jmax)[None, :] < self.nj[:, None]
        fail = active & (self.counts < np.uint64(cutoff))
        first_fail = np.argmax(fail, axis=1)
        has_fail = fail.any(axis=1)
        return np.where(has_fail, first_fail, self.nj).astype(np.int64)

    def clean(self, cutoff: int):
        """Truncate and suppress prefixes; returns (LinkStore on g's
        device, stats dict).  Emitted links are the maximal surviving
        paths; each one's count is the coverage of its final junction
        edge (ref _ltree_write_ctp_link: leaves only)."""
        L, Jmax = self.L, self.Jmax
        keep = self.keep_lengths(cutoff)
        emitted = np.zeros((L,), bool)
        count_out = np.zeros((L,), np.uint64)
        if L:
            t = keep
            for j in range(Jmax):
                sel = np.nonzero(t == j + 1)[0]
                if len(sel) == 0:
                    continue
                gj = self.gid[:, j]
                gmax = np.zeros(gj[-1] + 1, np.int64)
                np.maximum.at(gmax, gj, t)
                ok = gmax[gj[sel]] <= j + 1
                # truncated duplicates: the first of each (group, depth)
                gsel = gj[sel]
                first = np.concatenate([[True], gsel[1:] != gsel[:-1]])
                emitted[sel] = ok & first
                count_out[sel] = self.counts[sel, j]
        eidx = np.nonzero(emitted)[0]
        tkeep = keep[eidx]
        new_bases = self.bases[eidx].copy()
        mask = np.arange(Jmax)[None, :] < tkeep[:, None]
        new_bases *= mask
        jwords = max(1, (int(tkeep.max()) + 31) // 32) if len(eidx) else 1
        seq = lstore.pack_juncs(new_bases, tkeep, jwords)
        counts1 = np.minimum(count_out[eidx],
                             np.iinfo(np.uint32).max).astype(np.uint32)
        # back into the store's own colour column
        nseen = np.zeros((len(eidx), self.ncols), np.uint32)
        nseen[:, self.colour] = counts1
        store = lstore.assemble_csr(self.verts[eidx], seq, tkeep, nseen,
                                    self.g.capacity, self.g.device)
        stats = {
            "num_links": int(len(eidx)),
            "num_kmers_with_links":
                int(len(np.unique(self.verts[eidx] >> 1))),
            "num_link_bytes": int(((tkeep + 3) // 4).sum()),
        }
        return store, stats

    # -- inspection --------------------------------------------------

    def covg_hist(self, distsize: int, covgsize: int) -> np.ndarray:
        """hists[dist][covg]: unique tree edges at kmer-distance dist
        with coverage covg (covg capped; ref ltree_update_covg_hists)."""
        if self.jpos is None:
            raise ValueError("covg_hist requires traced junction positions")
        hists = np.zeros((distsize, covgsize), np.uint64)
        for j in range(self.Jmax):
            sel = self.rep[:, j]
            if not sel.any():
                continue
            d = self.jpos[sel, j]
            c = np.minimum(self.counts[sel, j],
                           np.uint64(covgsize - 1)).astype(np.int64)
            ok = (d >= 0) & (d < distsize)
            np.add.at(hists, (d[ok], c[ok]), 1)
        return hists

    def list_rows(self, keep: np.ndarray | None = None):
        """(SeqLen, Covg) of every surviving unique edge (ref
        ltree_write_list; SeqLen = kmer_size + dist + 1).  With keep
        (after cleaning) only edges on a kept path are listed."""
        if self.jpos is None:
            raise ValueError("list requires traced junction positions")
        out = []
        for j in range(self.Jmax):
            sel = self.rep[:, j].copy()
            if keep is not None and sel.any():
                gj = self.gid[:, j]
                gmax = np.zeros(gj[-1] + 1, np.int64)
                np.maximum.at(gmax, gj, keep)
                sel &= gmax[gj] > j
            if not sel.any():
                continue
            d = self.jpos[sel, j]
            out.append(np.stack(
                [self.g.k + d + 1, self.counts[sel, j].astype(np.int64)],
                axis=1))
        if not out:
            return np.zeros((0, 2), np.int64)
        return np.concatenate(out, axis=0)


def suggest_cutoff(hists: np.ndarray):
    """A cleaning threshold from a dist x covg matrix: the kmer-cleaning
    threshold picker on each row of dist >= 1, and their median (ref
    ctx_links.c:83-116 print_suggest_cutoff)."""
    from ..graph.clean import pick_kmer_threshold
    distsize = hists.shape[0]
    cutoffs = np.zeros((distsize,), np.int64)
    sumcovgs = np.zeros((distsize,), np.int64)
    nfail = 0
    for d in range(1, distsize):
        sumcovgs[d] = int(hists[d].sum())
        row = hists[d].astype(np.float64)
        if len(row) < 10:
            row = np.concatenate([row, np.zeros(10 - len(row))])
        t = pick_kmer_threshold(row)[0]
        if t is None or t < 0:
            nfail += 1
            t = 0
        cutoffs[d] = t
    med = int(np.median(cutoffs[1:])) if distsize > 1 else 0
    return {"sumcovgs": sumcovgs[1:].tolist(),
            "cutoffs": cutoffs[1:].tolist(),
            "suggested_cutoff": med,
            "nthresh_failed": nfail}


def write_threshold_file(fh, sug: dict) -> None:
    fh.write("sumcovgs=" + ",".join(str(x) for x in sug["sumcovgs"]) + "\n")
    fh.write("cutoffs=" + ",".join(str(x) for x in sug["cutoffs"]) + "\n")
    fh.write(f"suggested_cutoff={sug['suggested_cutoff']}\n")


def write_dot(g: gstore.DBGraph, links: lstore.LinkStore, row: int,
              fh, edge_colour: int = 0) -> None:
    """DOT plot of one kmer's link tree (ref ltree_write_dot).

    The kmer's links are traced on g's device and the (tiny) trie is
    built on the host; node labels are the sequence runs between
    junctions, leaf labels the final junction base."""
    offs = links.offsets.cpu().numpy()
    sub_ids = np.concatenate([
        np.arange(offs[2 * row], offs[2 * row + 1]),
        np.arange(offs[2 * row + 1], offs[2 * row + 2])]).astype(np.int64)
    kstr = kmers_to_strings(
        g.keys[row:row + 1].cpu().numpy().view(np.uint64), g.k)[0]
    fh.write("digraph G {\n")
    fh.write('  node [shape=none fontname="Courier New" fontsize=9]\n')
    fh.write('  edge [shape=none fontname="Courier New" fontsize=9]\n')
    if len(sub_ids) == 0:
        fh.write("}\n")
        return
    sel = torch.from_numpy(sub_ids).to(links.device)
    sub = lstore.LinkStore(
        offsets=torch.zeros((2 * g.capacity + 1,), dtype=torch.int32,
                            device=links.device),
        seq=links.seq[sel], nj=links.nj[sel], nseen=links.nseen[sel])
    _o, sseq, snj, snseen = lstore.to_host(sub)
    nj = snj.astype(np.int64)
    nseen = snseen.sum(axis=1).astype(np.int64)
    bases = unpack_bases(sseq, nj)
    n_fw = int(offs[2 * row + 1] - offs[2 * row])
    orients = (np.arange(len(sub_ids)) >= n_fw).astype(np.int64)
    # trace each link for its junction positions and path bases
    start = np.full((len(sub_ids),), 2 * row, np.int64) + orients
    adj = adjmod.get_adjacency(g)
    jcap = max(int(nj.max()), 1)
    jp, _ok, tb, _bl = _trace(
        g, sub, torch.from_numpy(start), torch.arange(len(sub_ids)),
        edge_colour, 512, jcap, True, adj)
    jp, tb = jp.cpu().numpy(), tb.cpu().numpy()

    # the trie: node = (orient, prefix tuple); edges carry counts
    nodes = {}   # (orient, prefix) -> node id
    meta = {}    # id -> dict(seq, dist, children{base->child id or None},
                 #            counts{base->n})
    nid = [0]

    def get_node(orient, prefix, seq, dist):
        key = (orient, prefix)
        if key not in nodes:
            nodes[key] = nid[0]
            meta[nid[0]] = {"seq": seq, "dist": dist, "children": {},
                            "counts": {}}
            nid[0] += 1
        return nodes[key]

    roots = {}
    for li in range(len(sub_ids)):
        o = int(orients[li])
        prev = None
        for j in range(int(nj[li])):
            prefix = tuple(bases[li, :j])
            d = int(jp[li, j])
            if j == 0:
                seq = "".join(_BASECHARS[b] for b in tb[li, :d])
                node = get_node(o, prefix, seq, d)
                roots.setdefault(o, node)
            else:
                pd = int(jp[li, j - 1])
                seq = "".join(_BASECHARS[b] for b in tb[li, pd + 1:d])
                node = get_node(o, prefix, seq, d)
                m = meta[prev]
                m["children"][int(bases[li, j - 1])] = node
            b = int(bases[li, j])
            m = meta[node]
            m["counts"][b] = m["counts"].get(b, 0) + int(nseen[li])
            prev = node
        if prev is not None and int(nj[li]) > 0:
            meta[prev]["children"].setdefault(int(bases[li, nj[li] - 1]),
                                              None)
    for o in sorted(roots):
        tag = "fw" if o == 0 else "rv"
        fh.write(f'  kmer_{tag}[label="{kstr} ({"F" if o == 0 else "R"})"]'
                 "\n")
    for i, m in meta.items():
        label = m["seq"] if m["seq"] else "."
        fh.write(f'  node{i} [label="{label}"]\n')
        for b, cnt in m["counts"].items():
            if m["children"].get(b) is None:
                fh.write(f'  node{i}{_BASECHARS[b].lower()} '
                         f'[label="{_BASECHARS[b]}"]\n')
    for o in sorted(roots):
        tag = "fw" if o == 0 else "rv"
        fh.write(f"  kmer_{tag} -> node{roots[o]}\n")
    for i, m in meta.items():
        for b, cnt in sorted(m["counts"].items()):
            child = m["children"].get(b)
            if child is None:
                fh.write(f"  node{i} -> node{i}{_BASECHARS[b].lower()} "
                         f'[label=" {_BASECHARS[b]} {cnt}"]\n')
            else:
                fh.write(f"  node{i} -> node{child} "
                         f'[label=" {_BASECHARS[b]} {cnt}"]\n')
    fh.write("}\n")

"""Link health checks: every stored link must be walkable; counterpart of
mccortex_tpu/links/check.py (role of ref src/graph_paths/gpath_checks.c,
gpath_checks_all_paths, used by ctx_health_check.c).

For each link and each colour it is seen in, walk from the link's kmer in
its orientation along that colour's edges; at every in-colour fork the
link must supply a junction base that is an existing branch, and the walk
must not fall off the graph before every junction is consumed.  One
walker per (link, colour), all stepped together on the graph's device
(on a CUDA store the candidates go through the lookup kernel); the host
loop reads the live count once a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import edges as E
from ..graph import store as gstore
from ..ops import hashidx
from ..ops import kmer as kops
from . import store as lstore


def check_links(g: gstore.DBGraph, links: lstore.LinkStore,
                max_steps: int = 4096):
    """Returns (n_checked, n_failed, failed link ids)."""
    from .walk import link_vertices
    L = links.nlinks
    if L == 0:
        return 0, 0, np.zeros(0, np.int64)
    k = g.k
    dev = g.device
    lids, cols = np.nonzero(links.nseen[:L].cpu().numpy() != 0)
    if len(lids) == 0:
        return 0, 0, np.zeros(0, np.int64)
    B = len(lids)
    verts = link_vertices(links, g.capacity)[lids]
    lid_t = torch.from_numpy(lids).to(dev)
    col_t = torch.from_numpy(cols).to(dev)
    ar = torch.arange(B, device=dev)
    idx = torch.from_numpy(verts >> 1).to(dev)
    orient = torch.from_numpy((verts & 1).astype(np.uint8)).to(dev)
    nj = links.nj[lid_t]
    seq = links.seq[lid_t]
    okm = kops.oriented(g.keys[idx], orient, k)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)  # still walking
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    nuc = [torch.full((B,), n, dtype=torch.int64, device=dev)
           for n in range(4)]

    for _step in range(max_steps):
        live = alive & (pos < nj)
        if not bool(live.any()):
            break
        # in-colour candidate successors
        enib = E.with_orientation(g.edges[idx, col_t], orient)
        nxt_okm = torch.stack([kops.shift_append(okm, nuc[n], k)
                               for n in range(4)], dim=1)    # (B, 4, W)
        qkey, qo = kops.canonical(nxt_okm, k)
        qrow, qfound = hashidx.lookup(g.keys, qkey)
        qrow = qrow.long()
        in_col = g.covg[qrow, col_t[:, None]] != 0
        has_edge = ((enib[:, None].long() >> torch.arange(4, device=dev))
                    & 1).bool()
        cand_ok = has_edge & qfound & in_col & live[:, None]
        cnt = cand_ok.sum(dim=1)
        # dead end before the link is consumed -> fail
        fail_now = live & (cnt == 0)
        # fork: the link's junction base must be a candidate
        at_fork = live & (cnt > 1)
        jb = lstore.unpack_junc(seq, pos).long()
        fail_now = fail_now | (at_fork & ~cand_ok[ar, jb])
        failed = failed | fail_now
        alive = alive & ~fail_now
        # the next base: the junction base at a fork, else the single
        # candidate (the first, as np.argmax takes)
        single = torch.argmax(cand_ok.to(torch.int32), dim=1)
        takeb = torch.where(at_fork, jb, single)
        adv = alive & live & (cnt > 0)
        okm = torch.where(adv[:, None], nxt_okm[ar, takeb], okm)
        idx = torch.where(adv, qrow[ar, takeb], idx)
        orient = torch.where(adv, qo[ar, takeb], orient)
        pos = torch.where(adv & at_fork, pos + 1, pos)
    else:
        # out of steps with live walkers: they count as failed
        failed = failed | (alive & (pos < nj))

    bad = (failed | (pos < nj)).cpu().numpy()
    return B, int(bad.sum()), np.unique(lids[bad])

"""Breakpoint caller: large-event calling against a trusted reference;
counterpart of mccortex_tpu/calls/breakpoints.py.

Role of ref src/tools/breakpoint_caller.c: at every graph node where a
non-reference branch exists, walk the non-ref path (per colour, with
links) until >= min_ref_nkmers consecutive reference kmers are
re-acquired (search capped at max_ref_nkmers); emit the 5' flank (a
colinear reference run leading into the break), the allele path, and the
3' reference re-contact run.

Candidate break sites come from one vectorised pass over the store on
its device (ref kmer with an out-edge to a non-ref kmer); all (site,
branch, colour) walks run as one batched linked walk a colour
(links/walk.walk_linked, the walkers' first step forced as in
calls/bubbles.py); run assembly against the reference index happens on
the host over the recorded vertex paths, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import adjacency as adjmod
from ..graph import kmer_occur as KO
from ..graph import store as gstore
from ..graph import traverse as T
from ..graph.unitigs import _oriented_np
from ..links import store as lstore
from ..links import walk as lwalk
from ..ops import kmer as kops
from ..ops import sorted as sops
from ..utils.text import kmers_to_strings
from .bubbles import _force_first_step, _take_walkers

DEFAULT_MIN_REF = 5     # ref breakpoint_caller.h:12
DEFAULT_MAX_REF = 1000  # ref breakpoint_caller.h:14

_CHARS = np.frombuffer(b"ACGT", np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")


@dataclasses.dataclass
class Breakpoint:
    flank5p_seq: str
    flank5p_run: dict      # primary colinear ref run leading into the break
    flank3p_seq: str
    flank3p_run: dict      # primary ref re-contact run
    allele_seq: str        # bases strictly between the flanks
    cols: list
    # FULL colinear run lists per flank (ref breakpoint_caller.c:534-570
    # koruns_gzprint emits every run with its qoffset; the primary above
    # is the largest-match choice).  qoffset is in kmers, 0-based,
    # relative to the flank's own sequence.
    flank5p_runs: list = dataclasses.field(default_factory=list)
    flank3p_runs: list = dataclasses.field(default_factory=list)


def find_break_sites(g: gstore.DBGraph, ko: KO.KOGraph):
    """Vertices (2*row+orient) that are ref kmers with >=1 out-edge to a
    non-ref kmer; returns (verts, branch nibble of non-ref nexts)."""
    N = g.capacity
    dev = g.device
    uedges = gstore.union_edges(g).to(torch.int64)
    in_ref = KO.occurs_mask(ko, N)
    in_ref_t = torch.from_numpy(in_ref).to(dev)
    out_verts, out_nibs = [], []
    for o in (0, 1):
        okm = kops.oriented(g.keys, torch.full((N,), o, dtype=torch.uint8,
                                               device=dev), g.k)
        nib = (uedges >> (4 * o)) & 0xF
        nonref_nib = torch.zeros((N,), dtype=torch.uint8, device=dev)
        for n in range(4):
            has = ((nib >> n) & 1) > 0
            nxt = kops.shift_append(okm, torch.full(
                (N,), n, dtype=torch.int64, device=dev), g.k)
            key2, _ = kops.canonical(nxt, g.k)
            j, found = sops.lookup(g.keys, key2)
            nonref = has & found & ~in_ref_t[j.long()]
            nonref_nib |= nonref.to(torch.uint8) << n
        nonref_nib = nonref_nib.cpu().numpy()
        rows = np.nonzero(in_ref & (nonref_nib > 0))[0]
        out_verts.append(2 * rows + o)
        out_nibs.append(nonref_nib[rows])
    return (np.concatenate(out_verts), np.concatenate(out_nibs))


def call_breakpoints(g: gstore.DBGraph, ref: KO.RefGenome,
                     links: lstore.LinkStore | None = None,
                     min_ref: int = DEFAULT_MIN_REF,
                     max_ref: int = DEFAULT_MAX_REF,
                     max_flank: int = 1000):
    """Returns list[Breakpoint]."""
    ncols = g.ncols
    dev = g.device
    if links is None:
        links = lstore.empty(g.capacity, ncols, device=dev)
    ko = KO.build_kograph(g, ref)
    verts, nibs = find_break_sites(g, ko)
    if len(verts) == 0:
        return []

    # one walker per (site, nonref branch, colour) where fork+branch in
    # col, in that order
    covg_np = g.covg.cpu().numpy()
    rows = verts >> 1
    orients = verts & 1
    fork_okm = kops.oriented(g.keys[torch.from_numpy(rows).to(dev)],
                             torch.from_numpy(orients.astype(np.uint8)
                                              ).to(dev), g.k)
    branch_rows = np.zeros((len(verts), 4), np.int64)
    for n in range(4):
        nxt = kops.shift_append(fork_okm, torch.full(
            (len(verts),), n, dtype=torch.int64, device=dev), g.k)
        key2, _ = kops.canonical(nxt, g.k)
        jrow, _ = sops.lookup(g.keys, key2)
        branch_rows[:, n] = jrow.cpu().numpy()
    has_nuc = ((nibs[:, None] >> np.arange(4, dtype=np.uint8)) & 1) > 0
    want = (has_nuc[:, :, None] & (covg_np[rows] != 0)[:, None, :]
            & (covg_np[branch_rows] != 0))
    meta = np.stack(np.nonzero(want), axis=1)
    if len(meta) == 0:
        return []
    B = len(meta)
    max_steps = max_ref + min_ref + 2

    st = lwalk.linked_init(
        g, links,
        torch.from_numpy(rows[meta[:, 0]].astype(np.int32)).to(dev),
        torch.from_numpy(orients[meta[:, 0]].astype(np.uint8)).to(dev),
        max_steps)
    st = _force_first_step(
        g, links, st, torch.from_numpy(meta[:, 1].astype(np.uint8)).to(dev),
        torch.from_numpy(meta[:, 2].astype(np.int64)).to(dev))
    outs = {}
    adj = adjmod.get_adjacency(g)  # one row gather per step, not log2(N)
    hopinfo = lwalk.get_hopinfo(g, links)
    for c in set(meta[:, 2].tolist()):
        sel = np.nonzero(meta[:, 2] == c)[0]
        sub = _take_walkers(st, sel)
        sub = lwalk.walk_linked(g, links, sub, int(c), max_steps=max_steps,
                                ctpcol=min(int(c),
                                           links.nseen.shape[1] - 1),
                                adj=adj, hopinfo=hopinfo)
        lwalk.report_drops(sub, "breakpoints")
        outs[c] = (sel, sub)

    vert_paths = np.full((B, max_steps), -1, np.int32)
    base_paths = np.zeros((B, max_steps), np.uint8)
    lens = np.zeros(B, np.int32)
    for c, (sel, sub) in outs.items():
        # prefix-width returns (live pow2 bucket, not the full buffer)
        ob, ov = lwalk.fill_hop_outputs(g, sub)
        wv = min(ov.shape[1], vert_paths.shape[1])
        wb = min(ob.shape[1], base_paths.shape[1])
        vert_paths[sel[:, None], np.arange(wv)] = ov[:, :wv]
        base_paths[sel[:, None], np.arange(wb)] = ob[:, :wb]
        lens[sel] = sub.base.out_len.cpu().numpy()

    # 5p flanks: backward walks from each site (linkless, ref-tracking)
    usites = np.unique(meta[:, 0])
    rseed = rows[usites]
    rorient = 1 - orients[usites]
    stb = T.walk_init(g, torch.from_numpy(rseed.astype(np.int32)).to(dev),
                      torch.from_numpy(rorient.astype(np.uint8)).to(dev),
                      max_flank)
    stb = T.walk(g, stb, None, max_steps=max_flank)
    bverts = stb.out_vert.cpu().numpy()
    bbases = stb.out_bases.cpu().numpy()
    blens = stb.out_len.cpu().numpy()
    site_to_bi = {int(s): i for i, s in enumerate(usites)}

    keys_np = g.keys.cpu().numpy().view(np.uint64)
    calls = {}
    for w in range(B):
        si, n, c = meta[w]
        L = int(lens[w])
        if L < min_ref:
            continue
        path_v = vert_paths[w, :L]
        runs = KO.runs_of_path(ko, path_v, min_len=min_ref)
        if not runs:
            continue
        # earliest qualifying re-contact run (already qoffset-sorted)
        r3 = runs[0]
        if r3["qoffset"] > max_ref:
            continue
        # 5' flank: backward walk from the site; its vertices reversed
        # and complemented form the sequence INTO the site
        bi = site_to_bi[int(si)]
        bL = int(blens[bi])
        # the backward walk runs in the reversed orientation: include the
        # site vertex reversed so the run is colinear from qoffset 0
        back_path = np.concatenate(
            [[int(verts[si]) ^ 1], bverts[bi, :bL]])
        b_runs = KO.runs_of_path(ko, back_path, min_len=1)
        # runs contacting the break (qoffset 0 going backward) — a
        # repetitive flank yields several (ref picks up 5' runs only at
        # the first unitig, breakpoint_caller.c:254-263)
        r5bs = [r for r in b_runs if r["qoffset"] == 0]
        if not r5bs:
            continue
        # convert backward runs to forward orientation; primary = the
        # longest (the reference consumer's largest-match rule)
        r5bs.sort(key=lambda r: -r["len"])
        r5s = [{"chrom": r["chrom"], "first": r["last"],
                "last": r["first"], "strand": 1 - r["strand"],
                "len": r["len"]} for r in r5bs]
        r5b = r5bs[0]
        r5 = r5s[0]
        # sequences
        site_kmer = kmers_to_strings(_oriented_np(
            keys_np[rows[si]][None], np.array([orients[si]], np.uint8),
            g.k), g.k)[0]
        back_seq = _CHARS[bbases[bi, :min(bL, r5b["len"] - 1 + g.k)]
                          ].tobytes().decode()
        flank5p = back_seq[::-1].translate(_COMP) + site_kmer
        allele = _CHARS[base_paths[w, :r3["qoffset"]]].tobytes().decode()
        f3len = min(r3["len"], 100)
        flank3p = _CHARS[base_paths[w, r3["qoffset"]:r3["qoffset"] + f3len]
                         ].tobytes().decode()
        # full run lists with qoffsets relative to each flank's sequence
        flen5 = len(flank5p) - g.k + 1
        runs5 = [dict(r, qoffset=max(flen5 - r["len"], 0)) for r in r5s]
        runs3 = [dict(r, qoffset=r["qoffset"] - r3["qoffset"])
                 for r in runs]
        keyid = (int(si), int(n), allele, r3["chrom"], r3["first"])
        if keyid in calls:
            calls[keyid].cols.append(int(c))
        else:
            calls[keyid] = Breakpoint(
                flank5p_seq=flank5p, flank5p_run=r5,
                flank3p_seq=flank3p, flank3p_run=r3,
                allele_seq=allele, cols=[int(c)],
                flank5p_runs=runs5, flank3p_runs=runs3)
    return list(calls.values())

"""`.ctp` link file IO, the reference v4 text format; counterpart of
mccortex_tpu/io/ctp.py.

Layout (ref src/graph_paths/gpath_save.c:10-28, gpath_reader.c): gzip;
a pretty-printed JSON header object (braces balanced across lines);
comment lines starting '#'; a blank line; then per kmer with links:

    <kmer> <numlinks>
    [F|R] <njuncs> <nseen0,nseen1,...> <junction-bases>

The header carries per-colour contig length histograms ("paths" /
"contig_hists"), which `contigs` turns into its confidence table, and
the chain of commands that made the file.  Parsing and formatting are
host code (copies of the JAX package's); the kmer -> row resolution is
one batched binary search on the graph's device.  The header's
`generator` names this package.
"""

from __future__ import annotations

import gzip
import json
import os
import time

import numpy as np
import torch

from .. import __version__
from ..constants import CHAR_TO_BASE
from ..links import store as lstore
from ..ops import sorted as sops
from ..utils.text import kmers_to_strings, strings_to_kmers
from ..utils.timing import count

_BASECHARS = np.frombuffer(b"ACGT", np.uint8)


def _decode_juncs(seq: np.ndarray, nj: np.ndarray) -> list:
    """Packed (L, JW) uint64 -> list of L junction strings."""
    L = seq.shape[0]
    if L == 0:
        return []
    jmax = int(nj.max())
    bases = np.zeros((L, max(jmax, 1)), np.uint8)
    for p in range(jmax):
        w = p // 32
        sh = np.uint64(62 - 2 * (p % 32))
        bases[:, p] = ((seq[:, w] >> sh) & np.uint64(3)).astype(np.uint8)
    chars = _BASECHARS[bases]
    return [chars[i, :nj[i]].tobytes().decode() for i in range(L)]


def _provenance(command: str, prev_commands=None) -> list:
    entry = {
        "cmd": command,
        "cwd": os.getcwd(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    return [entry] + list(prev_commands or [])


def save_ctp(path: str, g, links: lstore.LinkStore, sample_names=None,
             command: str = "mctx thread", contig_hists=None,
             prev_commands=None) -> None:
    """Write the link store against graph g (its keys give the kmer
    strings).  contig_hists: optional per-colour {length_bp: count}."""
    offsets, seq, nj, nseen = lstore.to_host(links)
    ncols = nseen.shape[1]
    keys = g.keys.cpu().numpy().view(np.uint64)
    deg = np.diff(offsets)
    kmer_has = (deg[0::2] + deg[1::2]) > 0

    hists_json = []
    for c in range(ncols):
        h = (contig_hists[c] if contig_hists and c < len(contig_hists)
             else {})
        lens = sorted(int(x) for x in h)
        hists_json.append({
            "lengths": lens,
            "counts": [int(h[x]) for x in lens],
        })

    hdr = {
        "file_format": "ctp",
        "format_version": 4,
        "ncols": ncols,
        "kmer_size": g.k,
        "generator": f"mccortex_tpu_torch {__version__}",
        "commands": _provenance(command, prev_commands),
        "paths": {
            "num_kmers_with_paths": int(kmer_has.sum()),
            "num_paths": int(links.nlinks),
            "path_bytes": int(sum((nj + 3) // 4)),
            "contig_hists": hists_json,
        },
        "colours": [{"colour": c,
                     "sample": (sample_names[c] if sample_names else
                                f"colour{c}")}
                    for c in range(ncols)],
    }
    kstrs = kmers_to_strings(keys, g.k)
    count("ctp.kmers_formatted", len(keys))
    count("ctp.kmers_written", int(kmer_has.sum()))
    jstrs = _decode_juncs(seq, nj)
    cstrs = [",".join(str(int(x)) for x in row) for row in nseen]
    with gzip.open(path, "wt") as fh:
        fh.write(json.dumps(hdr, indent=2))
        fh.write("\n\n")
        fh.write("# This file was generated with mccortex_tpu\n")
        fh.write("# Format: [kmer] [num_paths]\n")
        fh.write("#   [FR] [num_juncs] [counts0,counts1,...] [juncs]\n\n")
        for r in np.nonzero(kmer_has)[0]:
            recs = []
            for o, oc in ((0, "F"), (1, "R")):
                v = 2 * r + o
                for li in range(offsets[v], offsets[v + 1]):
                    recs.append(f"{oc} {nj[li]} {cstrs[li]} {jstrs[li]}")
            fh.write(f"{kstrs[r]} {len(recs)}\n")
            for rec in recs:
                fh.write(rec + "\n")


def _split_header(text: str):
    """Return (header_json_str, line_offset_after_header, lines)."""
    lines = text.splitlines()
    depth = 0
    in_str = False
    esc = False
    for i, line in enumerate(lines):
        for ch in line:
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    return "\n".join(lines[:i + 1]), i + 1, lines
    raise ValueError("unterminated JSON header in .ctp file")


def load_ctp_header(path: str) -> dict:
    """Read just the JSON header of a .ctp file."""
    with gzip.open(path, "rt") as fh:
        text = fh.read()
    hdr_str, _, _ = _split_header(text)
    return json.loads(hdr_str)


def contig_hist_from_header(hdr: dict, col: int = 0) -> dict:
    """{length: count} of one colour from a .ctp header (ref
    gpath_reader_load_contig_hist, gpath_reader.c:64-95)."""
    hists = hdr.get("paths", {}).get("contig_hists", [])
    if col >= len(hists):
        return {}
    h = hists[col]
    return {int(l): int(c) for l, c in zip(h.get("lengths", []),
                                           h.get("counts", []))}


def load_ctp(path: str, g) -> lstore.LinkStore:
    """Parse a .ctp file into a LinkStore against graph g, on g's device.
    Each link kmer's row is found by one batched binary search
    (sorted.searchsorted_chunked, side "left") in g's keys."""
    with gzip.open(path, "rt") as fh:
        text = fh.read()
    hdr_str, body_start, lines = _split_header(text)
    hdr = json.loads(hdr_str)
    ncols = hdr.get("ncols", 1)
    if hdr.get("kmer_size") != g.k:
        raise ValueError(
            f"{path}: kmer_size {hdr.get('kmer_size')} != graph k={g.k}")

    kmer_strs = []       # unique kmer lines, in file order
    link_kmer_ix = []    # per link: index into kmer_strs
    orients, njs, count_strs, junc_strs = [], [], [], []
    npaths_left = 0
    for i in range(body_start, len(lines)):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            continue
        if npaths_left == 0:
            kstr, num = line.split()[:2]
            kmer_strs.append(kstr)
            npaths_left = int(num)
        else:
            parts = line.split()
            orients.append(0 if parts[0] == "F" else 1)
            njs.append(int(parts[1]))
            count_strs.append(parts[2])
            junc_strs.append(parts[3])
            link_kmer_ix.append(len(kmer_strs) - 1)
            npaths_left -= 1

    L = len(orients)
    if L == 0:
        return lstore.empty(g.capacity, ncols, device=g.device)

    keys = strings_to_kmers(kmer_strs, g.W)
    q = torch.from_numpy(keys.view(np.int64)).to(g.device)
    idx = sops.searchsorted_chunked(g.keys, q, side="left").cpu().numpy()
    idxc = np.clip(idx, 0, g.capacity - 1)
    found = (g.keys.cpu().numpy().view(np.uint64)[idxc] == keys).all(axis=1)
    if not found.all():
        bad = int(np.argmin(found))
        raise ValueError(f"{path}: link kmer {kmer_strs[bad]} not in graph")
    rows = idxc[np.array(link_kmer_ix)]

    njs = np.array(njs, np.int64)
    jmax = int(njs.max())
    # junction strings -> padded base-code matrix in one pass
    codes = CHAR_TO_BASE[np.frombuffer("".join(junc_strs).encode(),
                                       np.uint8)]
    starts = np.cumsum(njs) - njs
    bases_arr = np.zeros((L, jmax), np.uint8)
    pos = np.arange(jmax)
    take = starts[:, None] + pos[None, :]
    mask = pos[None, :] < njs[:, None]
    bases_arr[mask] = codes[take[mask]]

    nseens = np.zeros((L, ncols), np.uint32)
    for ix, cs in enumerate(count_strs):
        vals = cs.split(",")
        nseens[ix, :len(vals)] = [int(x) for x in vals]

    jwords = max(1, (jmax + 31) // 32)
    seq_packed = lstore.pack_juncs(bases_arr, njs, jwords)
    verts = rows.astype(np.int64) * 2 + np.array(orients, np.int64)
    return lstore.assemble_csr(verts, seq_packed, njs, nseens, g.capacity,
                               g.device)


def load_link_store(paths, g) -> lstore.LinkStore:
    store = None
    for p in paths:
        s = load_ctp(p, g)
        store = s if store is None else lstore.merge_stores(
            store, s, g.capacity)
    return store

"""Bubble/breakpoint call file IO (gzipped FASTA-like with JSON header);
a copy of mccortex_tpu/io/callfile.py whose header `generator` names
this package (every other byte as mctx writes it).

Format (ref src/tools/bubble_caller.c print_bubble,
src/basic/call_file_reader.c): JSON header, comment lines, then per call:

  >bubble.call<id>.5pflank kmers=N
  <seq>
  >bubble.call<id>.3pflank kmers=N
  <seq>
  >bubble.call<id>.branch.<i> kmers=N cols=0,1
  <seq>
  (blank line between calls)
"""

from __future__ import annotations

import gzip
import json

from .. import __version__


def write_bubble_file(path: str, bubbles, k: int, ncols: int,
                      max_allele: int, max_flank: int,
                      sample_names=None) -> None:
    hdr = {
        "file_format": "CtxBubbles",
        "format_version": 2,
        "ncols": ncols,
        "kmer_size": k,
        "generator": f"mccortex_tpu_torch {__version__}",
        "commands": [{"cmd": "mctx bubbles",
                      "max_allele_kmers": max_allele,
                      "max_flank_kmers": max_flank}],
        "colours": [{"colour": c,
                     "sample": (sample_names[c] if sample_names
                                else f"colour{c}")} for c in range(ncols)],
    }
    with gzip.open(path, "wt") as fh:
        fh.write(json.dumps(hdr, indent=2))
        fh.write("\n\n# This file was generated with mccortex_tpu\n\n")
        for i, b in enumerate(bubbles):
            fh.write(f">bubble.call{i}.5pflank kmers={max(len(b.flank5p) - k + 1, 1)}\n")
            fh.write(b.flank5p + "\n")
            fh.write(f">bubble.call{i}.3pflank kmers={len(b.flank3p)}\n")
            fh.write(b.flank3p + "\n")
            for j, br in enumerate(b.branches):
                cols = ",".join(str(c) for c in b.branch_colsets[j])
                fh.write(f">bubble.call{i}.branch.{j} kmers={len(br)} "
                         f"cols={cols}\n")
                fh.write(br + "\n")
            fh.write("\n")


def read_call_file(path: str):
    """Parse a call file -> (header dict, list of calls).  Each call:
    {'name': str, 'flank5p': seq, 'flank3p': seq,
     'branches': [(name_line, seq)]} (ref call_file_reader.c:6-30:
    lines 0-3 are flanks, alleles at indices 4+)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        text = fh.read()
    lines = text.splitlines()
    depth = 0
    in_str = esc = False
    hdr_end = -1
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
        if depth == 0 and i >= 0 and lines[0].startswith("{"):
            hdr_end = i
            break
    hdr = json.loads("\n".join(lines[:hdr_end + 1])) if hdr_end >= 0 else {}
    calls = []
    cur = None
    i = hdr_end + 1
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line.startswith(">"):
            name = line[1:]
            seq = lines[i].strip() if i < len(lines) else ""
            i += 1
            callname = name.split(".")[0] + "." + name.split(".")[1]
            if cur is None or cur["name"] != callname:
                if cur is not None:
                    calls.append(cur)
                cur = {"name": callname, "flank5p": "", "flank3p": "",
                       "branches": []}
            if ".5pflank" in name:
                cur["flank5p"] = seq
                cur["flank5p_hdr"] = name
            elif ".3pflank" in name:
                cur["flank3p"] = seq
                cur["flank3p_hdr"] = name
            else:
                cur["branches"].append((name, seq))
    if cur is not None:
        calls.append(cur)
    return hdr, calls

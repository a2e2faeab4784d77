"""Shared command-line options of the port's commands (the subset of
mccortex_tpu/cli/common.py that `build` uses).

- --quiet silences [mctx] status lines (stderr);
- --force is required to overwrite an existing output file;
- --device picks where the kernels run: cuda (default) or cpu (the plain
  PyTorch versions).  cuda without a CUDA device is an error, never a
  silent fall back to the CPU.
"""

from __future__ import annotations

import os
import sys

import torch


class Status:
    """[mctx] status lines on stderr, unless quiet."""

    def __init__(self, quiet: bool = False):
        self.quiet = quiet

    def __call__(self, msg: str) -> None:
        if not self.quiet:
            print(f"[mctx] {msg}", file=sys.stderr)


def add_common(p):
    g = p.add_argument_group("general options")
    g.add_argument("-q", "--quiet", action="store_true",
                   help="silence status output normally printed to stderr")
    g.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output files")
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run the kernels on the CUDA device (default) or "
                        "their plain PyTorch versions on the CPU")
    return p


def check_outfile(path, force: bool) -> None:
    """Refuse to overwrite without --force."""
    if path and path != "-" and not force and os.path.exists(str(path)):
        raise ValueError(
            f"output file already exists: {path} (use -f/--force)")


def apply_common(args, *out_paths) -> tuple:
    """Call straight after parsing: checks every output path against
    --force and resolves --device.  Returns (status, device)."""
    for o in out_paths:
        check_outfile(o, args.force)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda: no CUDA device is available "
                         "(pass --device cpu for the plain PyTorch path)")
    return Status(args.quiet), torch.device(args.device)


def check_kmer(k: int, p=None) -> int:
    """Kmer size must be odd and 3..63."""
    msg = None
    if not (3 <= int(k) <= 63):
        msg = f"kmer size must be 3..63, got {k}"
    elif int(k) % 2 == 0:
        msg = f"kmer size must be odd, got {k}"
    if msg:
        if p is not None:
            p.error(msg)
        raise ValueError(msg)
    return int(k)

"""Shared command-line options of the port's commands (counterpart of
mccortex_tpu/cli/common.py).

- --quiet silences [mctx] status lines (stderr);
- --force is required to overwrite an existing output file;
- --memory is a budget for the store, checked by utils/membudget;
- --nkmers is a hint of the store's capacity (the store grows exactly);
- --threads is accepted for parity (the device work is parallel anyway);
- --devices N runs on N devices (parallel/shard.py): on cuda the cards
  cuda:0 .. cuda:N-1 ('auto' = every visible card), on cpu N shards of
  the CPU device.  build, contigs, thread --no-gap-fill and bubbles
  split their work over them; the other commands accept the flag and
  run on one device, as mctx's do;
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


def parse_size(s: str | None) -> int | None:
    """'20M'/'8G'/'1T'/'4096' -> int."""
    if s is None:
        return None
    s = str(s).strip()
    mult = 1
    suffixes = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1].upper() in suffixes:
        mult = suffixes[s[-1].upper()]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise ValueError(f"bad size value: {s!r} (expected e.g. 20M, 8G)")


def nkmers_hint(args) -> int | None:
    return parse_size(getattr(args, "nkmers", None))


def devices_arg(args) -> list:
    """Resolve --devices to a list of torch.devices on --device: cuda:0
    .. cuda:N-1 ('auto' = every visible card), or N shards of the CPU
    ('auto' = one)."""
    v = getattr(args, "devices", None)
    dev = torch.device(args.device)
    if v is None:
        return [dev]
    auto = str(v).lower() == "auto"
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        n = avail if auto else int(v)
    else:
        n = 1 if auto else int(v)
    if n < 1:
        raise ValueError("--devices must be >= 1")
    if dev.type != "cuda":
        return [dev] * n
    if n > avail:
        raise ValueError(f"--devices {n} > {avail} visible devices")
    return [torch.device("cuda", i) for i in range(n)]


def add_common(p, memory: bool = False, nkmers: bool = False):
    g = p.add_argument_group("general options")
    g.add_argument("-q", "--quiet", action="store_true",
                   help="silence status output normally printed to stderr")
    g.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output files")
    if memory:
        g.add_argument("-m", "--memory", default=None,
                       help="memory budget for the store, e.g. 8G (fails "
                            "fast if the graph cannot fit)")
    if nkmers:
        g.add_argument("-n", "--nkmers", default=None,
                       help="initial kmer-store capacity hint, e.g. 20M "
                            "(the store grows exactly as needed)")
    g.add_argument("--devices", default=None,
                   help="devices to run on: a count, or 'auto' for every "
                        "visible card (N shards of the CPU with --device "
                        "cpu)")
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

"""The benchmark of mccortex_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of BENCHMARK.json (at the root of the checkout): makes the
sample's reads from the seed, sets up, warms up, drives the port's CLI
for `--seconds`, checks the outputs against the plain reference in
benchmark/reference, and prints one JSON line as the last line of its
standard output.  With `--trace 0` the line carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics.  It exits non-zero and
prints no result without the cards the cell asks for, or when jax,
jaxlib, flax or mccortex_tpu was loaded.  `--list` prints the cells.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true",
                   help="print the cells of BENCHMARK.json and exit")
    args = p.parse_args(argv)
    from benchmark.harness import runner, spec
    if args.list:
        print("\n".join(spec.list_cells(ROOT)))
        return 0
    if not args.workload:
        p.error("--workload is required")
    try:
        result, rows = runner.run_cell(ROOT, args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       t_process=T_PROCESS)
    except runner.NoCard as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    found = runner.forbidden_modules()
    if found:
        print(f"[bench] loaded in this process: {', '.join(found)}; the "
              f"benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

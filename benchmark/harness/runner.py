"""One run of one cell: inputs from the seed, set-up, warm-up, the
measured window, the metrics, the check against the plain reference, and
the result line.

The window is a closed loop of one user: jobs run back to back, and a
job that starts before `seconds` are up runs to its end and counts.  A
rate is all the work of those jobs over all their time.  With trace on,
the window's first job runs under torch.profiler.
"""

from __future__ import annotations

import gc
import shutil
import subprocess
import sys
import tempfile
import time

from benchmark.harness import spec as bspec
from benchmark.harness.driver import Driver
from benchmark.harness.profile import Profile, profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "mccortex_tpu")


class NoCard(RuntimeError):
    pass


class Run:
    """What the metric readers and the check read."""

    def __init__(self, cell, driver, seed, device):
        self.cell, self.driver, self.seed, self.device = (cell, driver,
                                                          seed, device)
        self.config, self.traffic = cell.config, cell.traffic
        self.warmup, self.jobs = None, []
        self.setup_s = None
        self.profile = None          # harness.profile.Profile of one job
        self.profiled_job = None
        self.setup_peak_bytes = self.window_peak_bytes = None

    @property
    def done(self) -> list:
        return [j for j in self.jobs if j.ok]

    @property
    def timed(self) -> list:
        """The completed jobs that ran without the profiler, or all the
        completed jobs when the profiled one is the only one: the spans
        of a profiled job hold the profiler's own cost."""
        rest = [j for j in self.done if j is not self.profiled_job]
        return rest or self.done


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port may not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_info(chips: int) -> dict:
    """The card's name, count and power limit; NoCard without one."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and "
                     "never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} visible")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def _metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = bspec.metric_reader(m["name"]).read(run, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_process: float | None = None,
             log=sys.stderr) -> tuple:
    """(result dict, check rows) of one run.  Raises NoCard on a machine
    without the cards the cell asks for (device "cuda")."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    cell = bspec.Cell(root, workload)
    cuda = device == "cuda"
    info = card_info(cell.chips) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    from benchmark.data import synth
    work = tempfile.mkdtemp(prefix="mctx-bench-")
    try:
        reads = synth.make_sample(cell.config["sample"], seed)
        driver = Driver(cell.traffic, cell.config, reads, work, device)
        run = Run(cell, driver, seed, device)
        driver.write_inputs()
        driver.setup()
        # the warm-up job reads the last input file, the window starts at
        # the first
        run.warmup = driver.job(driver.n_inputs() - 1)
        if not run.warmup.ok:
            bad = next(s for s in run.warmup.steps if s.rc != 0)
            raise RuntimeError(f"warm-up job failed: {' '.join(bad.argv)}\n"
                               f"{bad.status[-2000:]}")
        if cuda:
            torch.cuda.synchronize()
            run.setup_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        run.setup_s = time.perf_counter() - t_process
        print(f"[bench] {workload} seed {seed}: set-up {run.setup_s:.3f}s",
              file=log)

        t0 = time.perf_counter()
        i = 0
        traced = None
        while time.perf_counter() - t0 < seconds:
            with profiled(trace and i == 0, cuda) as holder:
                job = driver.job(i, mark=trace and i == 0)
            if holder.prof is not None:
                traced, run.profiled_job = holder.prof, job
            run.jobs.append(job)
            print(f"[bench] job {i}: {job.seconds:.3f}s "
                  f"{'ok' if job.ok else 'FAILED'}", file=log)
            i += 1
        if cuda:
            torch.cuda.synchronize()
            run.window_peak_bytes = torch.cuda.max_memory_allocated()
            info["memory_peak_bytes"] = max(run.setup_peak_bytes,
                                            run.window_peak_bytes)
        else:
            info["memory_peak_bytes"] = 0
        if traced is not None:
            run.profile = Profile(traced)
            del traced
            info["busy_s"] = run.profile.busy_s()
            info["window_s"] = run.profile.window_s

        metrics = (cell.per_layer() if trace else cell.end_to_end())
        result = {"correct": None, "attempted": len(run.jobs),
                  "failed": sum(not j.ok for j in run.jobs),
                  "metrics": _metrics(run, metrics), "device": info}
        if trace and run.profile is not None:
            result["breakdown"] = {
                "device_ops": run.profile.top_device_ops(),
                "idle_gaps": run.profile.idle_gaps()}
            run.profile = None

        # the program's state goes before the reference runs
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        rows = bspec.check_module(cell.traffic["check"]).check(run)
        print(f"[bench] check {time.perf_counter() - t_check:.3f}s", file=log)
        if result["failed"]:
            rows.append(("jobs_failed", result["failed"], 0))
        result["correct"] = all(v <= lim for _, v, lim in rows)
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in rows}
        return result, rows
    finally:
        shutil.rmtree(work, ignore_errors=True)

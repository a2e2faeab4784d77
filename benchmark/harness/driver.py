"""The general job driver: one closed loop of one user over the port's CLI.

A traffic mix (benchmark/traffic/<mix>.json) is data:

    {"inputs": [{"file": "reads.fq"},
                {"file": "chunk_{i}.fq", "chunk_reads": 16384}],
     "setup": [[<mctx argv>], ...],
     "job": {"input": "reads.fq" | "chunk_{i}.fq",
             "steps": [[<mctx argv>], ...],
             "outputs": ["{work}/raw.ctx", ...]},
     "check": "<module of benchmark/reference/checks>"}

Every argv element may name {k}, {sample}, {work}, {device}, {i} (the
job's number) and {chunk} (the path of the job's input).  An input
without `chunk_reads` holds all the sample's reads; one with it is cut
into files of that many reads, and job i reads chunk i modulo their
number.  Each step is `mccortex_tpu_torch.cli.main.main(argv)`, called in
this process: the path users run.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import time
import traceback

import numpy as np


class Step:
    __slots__ = ("argv", "seconds", "spans", "status", "rc")

    def __init__(self, argv, seconds, spans, status, rc):
        self.argv, self.seconds, self.spans = argv, seconds, spans
        self.status, self.rc = status, rc

    @property
    def command(self) -> str:
        return self.argv[0]


class Job:
    """One job: its steps, its wall seconds (host clock, the last step
    ending in a synchronised write of its output), and what it read."""

    def __init__(self, index, steps, seconds, reads, bases, digests):
        self.index, self.steps, self.seconds = index, steps, seconds
        self.reads, self.bases, self.digests = reads, bases, digests

    @property
    def ok(self) -> bool:
        return all(s.rc == 0 for s in self.steps)


def _digest(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class Driver:
    def __init__(self, traffic: dict, config: dict, reads: np.ndarray,
                 work: str, device: str):
        self.traffic, self.config = traffic, config
        self.reads, self.work, self.device = reads, work, device
        self.inputs = {}        # template -> [path of each file]

    # -- inputs -----------------------------------------------------------
    def write_inputs(self) -> None:
        from benchmark.data import synth
        for spec in self.traffic["inputs"]:
            tmpl = spec["file"]
            n = spec.get("chunk_reads") or len(self.reads)
            files = []
            for i, s in enumerate(range(0, len(self.reads), n)):
                part = self.reads[s:s + n]
                path = os.path.join(self.work, tmpl.format(i=i))
                synth.write_fastq(path, part)
                files.append(path)
            self.inputs[tmpl] = files

    def chunk_reads(self, template: str, i: int) -> np.ndarray:
        """The reads of input `template`'s file for job i."""
        spec = next(s for s in self.traffic["inputs"]
                    if s["file"] == template)
        n = spec.get("chunk_reads") or len(self.reads)
        nfiles = len(self.inputs[template])
        s = (i % nfiles) * n
        return self.reads[s:s + n]

    def n_inputs(self) -> int:
        """How many files the job's input is cut into."""
        return len(self.inputs[self.traffic["job"]["input"]])

    # -- steps ------------------------------------------------------------
    def _fields(self, i: int | None) -> dict:
        f = dict(k=self.config["k"], sample=self.config["sample_name"],
                 work=self.work, device=self.device)
        if i is not None:
            tmpl = self.traffic["job"]["input"]
            files = self.inputs[tmpl]
            f.update(i=i, chunk=files[i % len(files)])
        return f

    def expand(self, argv, i: int | None = None) -> list:
        f = self._fields(i)
        return [str(a).format(**f) for a in argv]

    def run_step(self, argv, mark: bool = False) -> Step:
        """One CLI command in this process: its rc, host seconds, the
        port's spans and its status lines (stderr)."""
        from mccortex_tpu_torch.cli.main import main as mctx_main
        from mccortex_tpu_torch.utils import timing
        from benchmark.harness.profile import step_mark
        err, out = io.StringIO(), io.StringIO()
        timing.SPANS.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(out), step_mark(mark, argv[0]):
            try:
                rc = mctx_main(list(argv))
            except SystemExit as e:       # argparse errors
                rc = e.code if isinstance(e.code, int) else 2
            except Exception:             # a fault of the program: the
                rc = 1                    # job fails, the run goes on
                traceback.print_exc()
        seconds = time.perf_counter() - t0
        return Step(list(argv), seconds, dict(timing.SPANS), err.getvalue(),
                    int(rc or 0))

    def setup(self) -> None:
        for argv in self.traffic.get("setup", []):
            st = self.run_step(self.expand(argv))
            if st.rc != 0:
                raise RuntimeError(f"set-up step failed (rc {st.rc}): "
                                   f"{' '.join(st.argv)}\n{st.status[-2000:]}")

    def job(self, i: int, mark: bool = False) -> Job:
        spec = self.traffic["job"]
        steps = []
        t_start = time.perf_counter()
        for argv in spec["steps"]:
            st = self.run_step(self.expand(argv, i), mark)
            steps.append(st)
            if st.rc != 0:
                break
        t_end = time.perf_counter()
        part = self.chunk_reads(spec["input"], i)
        digests = {}
        if all(s.rc == 0 for s in steps):
            for o in spec.get("outputs", []):
                path = self.expand([o], i)[0]
                digests[o] = _digest(path)
        return Job(i, steps, t_end - t_start, len(part),
                   int((part < 4).sum()), digests)

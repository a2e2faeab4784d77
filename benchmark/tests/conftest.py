"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's cells
at a size a test can hold (100 kb genomes, chunks of 2,048 reads), run on
the CPU through the harness with the card's check skipped.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = (1 << 33) + 11      # wider than 32 bits, as a run's seed may be


def make_tiny_root(dst: str) -> str:
    """A root with BENCHMARK.json and the benchmark's configurations and
    mixes, cut to a tiny size."""
    bench = os.path.join(ROOT, "benchmark")
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(bench, sub),
                        os.path.join(dst, "benchmark", sub))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for name in os.listdir(os.path.join(dst, "benchmark", "configs")):
        path = os.path.join(dst, "benchmark", "configs", name)
        cfg = json.load(open(path))
        s = cfg["sample"]
        s["genome_bp"] = 100_000
        if "snps" in s:
            s.update(snps=100, indels=10)
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(dst, "benchmark", "traffic")):
        path = os.path.join(dst, "benchmark", "traffic", name)
        mix = json.load(open(path))
        for inp in mix["inputs"]:
            if "chunk_reads" in inp:
                inp["chunk_reads"] = 2048
        json.dump(mix, open(path, "w"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))

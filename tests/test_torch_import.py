"""The port (mccortex_tpu_torch) imports torch and numpy only: never jax,
never mccortex_tpu, and it builds no kernel at import time."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mccortex_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mccortex_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
for n in ("links.thread", "links.walk", "links.check", "align.correct",
          "links.link_tree", "cli.commands3", "calls.bubbles",
          "calls.pop_bubbles", "calls.breakpoints", "calls.genotyping",
          "calls.calls2vcf", "calls.vcfgeno", "io.callfile", "io.vcf",
          "io.bcf", "align.nw", "cli.pipeline"):
    assert pkg.__name__ + "." + n in names, n
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "triton"))
             or m == "mccortex_tpu" or m.startswith("mccortex_tpu."))
from mccortex_tpu_torch.ops.kernels import _build
assert not _build._libs and not _build.LOGS   # nothing built or loaded
from mccortex_tpu_torch import native
assert native._lib is None and not native._tried
print(len(names), bad)
assert not bad, bad
"""


def test_every_module_imports_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 67      # ... incl. calls.*, io.{callfile,vcf,bcf}


def _sources(exts):
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(exts):
                yield os.path.join(d, f)


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+mccortex_tpu(\.|\s|$)",
    r"torch\.compile\b",
])
def test_python_sources_avoid(pattern):
    rx = re.compile(pattern, re.M)
    hits = [p for p in _sources((".py",)) if rx.search(open(p).read())]
    assert not hits, hits


def test_cuda_sources_use_no_device_library():
    rx = re.compile(r"cub::Device|thrust|#include\s*<torch")
    srcs = list(_sources((".cu", ".cuh")))
    assert {os.path.basename(p) for p in srcs} >= {
        "frontend.cu", "segreduce.cu", "mergepath.cu", "lookup.cu",
        "bitonic.cu"}
    hits = [p for p in srcs if rx.search(open(p).read())]
    assert not hits, hits


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from mccortex_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.function("segreduce", "mctx_segreduce", 6, 7)
    assert _build.build(()) == 0.0


@pytest.mark.parametrize("module", ["ops/kernels/bitonic.py",
                                    "ops/kernels/mergepath.py"])
def test_kernel_sorts_call_no_library_sort(module):
    """The mp and bitonic engines' wrappers sort with their kernels: the
    only torch.sort they may reach is inside a plain version, which
    ops.sorted.argsort_planes holds."""
    src = open(os.path.join(PKG, module)).read()
    assert not re.search(r"torch\.(sort|argsort|searchsorted|msort)\b", src)
    assert not re.search(r"\.(sort|argsort)\(", src)
    assert not re.search(r"\btry\b", src)         # no fallback


def test_unknown_mctx_sort_raises_at_import():
    env = dict(os.environ, MCTX_SORT="quick")
    r = subprocess.run([sys.executable, "-c",
                        "import mccortex_tpu_torch.graph.build"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "MCTX_SORT" in r.stderr and "quick" in r.stderr

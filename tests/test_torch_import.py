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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "triton"))
             or m == "mccortex_tpu" or m.startswith("mccortex_tpu."))
from mccortex_tpu_torch.ops.kernels import _build
assert not _build._libs and not _build.LOGS   # nothing built or loaded
print(len(names), bad)
assert not bad, bad
"""


def test_every_module_imports_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 25


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
        "frontend.cu", "segreduce.cu", "mergepath.cu", "lookup.cu"}
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

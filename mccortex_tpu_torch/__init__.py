"""mccortex_tpu_torch: the PyTorch + CUDA port of mccortex_tpu.

First slice: `build` (reads -> coloured `.ctx` graph) end to end.  Plain
tensor code is PyTorch; the three kernels on the build path
(ops/kernels: front-end, segmented reduce, merge path) are CUDA C++ for
Hopper (csrc/), compiled with nvcc at first use.  Every kernel wrapper
runs its plain PyTorch version for CPU tensors and launches its kernel
for CUDA tensors.

Kmer words travel as int64 bit views (word 0 most significant, the
kmer in the low 2k bits) or as int32 limb planes, never as torch.uint64:
torch has no shifts, sort or searchsorted for it.  At the file boundary
they are numpy uint64 views.

This package imports torch and numpy only: never jax, never mccortex_tpu
(whose __init__ imports jax).
"""

__version__ = "0.1.0"

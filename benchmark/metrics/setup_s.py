"""setup_s: seconds from the start of the process to the start of the
window (imports, CUDA context, kernels from the build cache, the inputs
from the seed, the cell's set-up steps and one warm-up job); host clock."""


def read(run, name):
    return run.setup_s

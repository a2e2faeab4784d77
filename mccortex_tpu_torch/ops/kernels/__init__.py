"""Hand-written CUDA kernels for Hopper (sources in ../../csrc), each with
its plain PyTorch version: a wrapper runs the plain version for CPU
tensors and launches the kernel for CUDA tensors."""

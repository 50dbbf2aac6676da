"""Kernels of the port: plain PyTorch versions, CUDA wrappers and
dispatchers (CPU tensors take the plain version, CUDA tensors the kernel)."""

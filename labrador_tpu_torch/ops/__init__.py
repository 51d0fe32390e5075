"""Tensor operations of the port: modular arithmetic, transforms, the PRG,
and the CUDA commitment kernels with their plain PyTorch versions."""

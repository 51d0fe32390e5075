"""labrador_tpu_torch — the LaBRADOR proof system on PyTorch and CUDA.

A port of ``labrador_tpu`` (the JAX/Pallas package, which stays the
reference) to PyTorch for one NVIDIA H100.  Plain tensor code is PyTorch;
the three commitment kernels on the interactive prove -> verify path are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), each with a plain PyTorch
version beside it that the CPU path and the tests use.

This slice covers the interactive mode at small q (q <= ops.modmath.P_MAX);
every other branch raises ``NotImplementedError`` naming its later slice.
The package never imports JAX: of the old package it imports only the
JAX-free ``labrador_tpu.params``.
"""

from .params import LabradorParams, D, TAU, T_OPNORM

__all__ = ["LabradorParams", "D", "TAU", "T_OPNORM"]

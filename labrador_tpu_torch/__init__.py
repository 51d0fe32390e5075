"""labrador_tpu_torch — the LaBRADOR proof system on PyTorch and CUDA.

A port of ``labrador_tpu`` (the JAX/Pallas package, which stays the
reference) to PyTorch for one NVIDIA H100.  Plain tensor code is PyTorch;
the three commitment kernels on the interactive prove -> verify path are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), and so is the fused
negacyclic polymul that recursion runs, each with a plain PyTorch version
beside it that the CPU path and the tests use.

The port covers the interactive and the Fiat-Shamir mode, phased and
checkpointed proving, and recursion (``recursion.fold``) at small q (q <=
ops.modmath.P_MAX) and at the 2^32-scale modulus (2^32 < q < 2^33, ``cli
--big-q``); the commitment kernels have a mode for each.  Multi-device
sharding is not ported.  The package imports nothing of JAX or of
``labrador_tpu``.
"""

from .params import LabradorParams, D, TAU, T_OPNORM

__all__ = ["LabradorParams", "D", "TAU", "T_OPNORM"]

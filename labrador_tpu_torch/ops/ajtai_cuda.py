"""Ajtai commitment t = A s: the CUDA kernel (``csrc/ajtai.cu``) and its
plain PyTorch version.

Replaces ``labrador_tpu/ops/ajtai_pallas.py`` (``ajtai_commit_pallas``),
both its branches: small q, and the 2^32-scale modulus (``big`` in the
Pallas kernel, ``circulant_limbs_big``), whose launches count in
``KERNEL_BIG``.  A is the virtual CRS matrix (kappa, n, d) at offset
row * n * d; it is expanded in the kernel's registers and never stored.
The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .ring_stream import (check_big_operand, check_q, launch_shape,
                          ring_stream_plain)
from .zq import is_big

KERNEL = cuda_lib.KernelInfo(
    name="ajtai_commit",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:234")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="ajtai_commit_bigq",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:173")


def ajtai_commit(crs, witness: torch.Tensor) -> torch.Tensor:
    """t (r_eff, kappa, d) mod q for witness (r_eff, n, d) residues in
    [0, q) or signed values of magnitude at most q/2 (the big-q witness
    convention); r_eff is the witness's own leading dim (r in proving, 1 for
    the verifier's check 15)."""
    if witness.is_cuda:
        return _launch(crs, witness)
    if witness.device.type == "cpu":
        return ajtai_commit_plain(crs, witness)
    raise ValueError(f"no Ajtai kernel for device {witness.device}")


def ajtai_commit_plain(crs, witness: torch.Tensor) -> torch.Tensor:
    p = crs.params
    nd = p.n * p.d

    def draw(l0: int, l1: int) -> torch.Tensor:
        return crs._expand_dyn(l0 * p.d, 0, 0, (p.kappa, l1 - l0, p.d),
                               (nd, p.d, 1), device=witness.device)

    return ring_stream_plain(draw, witness, p.kappa, p.q)


def _launch(crs, witness: torch.Tensor) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    r_eff = witness.shape[0]
    cuda_lib.require_cuda_operand(witness, "witness", (r_eff, p.n, p.d))
    check_big_operand(witness, p.q, "witness")
    if r_eff * p.kappa * p.d >= 1 << 31 or p.n * p.d >= 1 << 31:
        raise ValueError("Ajtai shape beyond the kernel's int32 indexing")
    splits = launch_shape(p.kappa, r_eff, p.n)
    part = torch.empty((splits, r_eff, p.kappa, p.d), dtype=torch.int64,
                       device=witness.device)
    out = torch.empty((r_eff, p.kappa, p.d), dtype=torch.int64,
                      device=witness.device)
    lib = cuda_lib.load().lib
    err = lib.ajtai_commit_launch(
        witness.data_ptr(), part.data_ptr(), out.data_ptr(), r_eff, p.n,
        p.kappa, p.q, crs.key[0], crs.key[1], splits,
        cuda_lib.stream_ptr(witness.device))
    cuda_lib.check(err)
    (KERNEL_BIG if is_big(p.q) else KERNEL).launches += 1
    return out

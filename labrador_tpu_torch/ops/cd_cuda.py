"""The C/D triangle sums sum_lin M_lin[row] (*) dig_lin: the CUDA kernel
(``csrc/cd.cu``) and its plain PyTorch version.

Replaces ``labrador_tpu/ops/cd_pallas.py`` (``cd_sum_pallas``), both its
branches: small q, and the 2^32-scale modulus (signed digits, launches
counted in ``KERNEL_BIG``).  The u1 C-term (M = C, g digits, t_used = t_2) and u2 (M = D, h digits,
t_used = t_1).  The column vector of stream entry lin = tri * t_used + k
sits at base + oc * kappa_2 * d with oc = tri * t_1 + k — the t_1
multiplier also for C (``structs.rs:106``).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .ring_stream import (barrett_m, check_big_operand, check_q,
                          launch_shape, ring_stream_plain)
from .zq import is_big

KERNEL = cuda_lib.KernelInfo(
    name="cd_sum",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:183")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="cd_sum_bigq",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:128")


def cd_sum(crs, dig_stream: torch.Tensor, base_off: int,
           t_used: int) -> torch.Tensor:
    """(kappa_2, d) mod q for dig_stream (n_tri, t_used, d) digits
    (residues mod q, or signed at big q); base_off is ``crs._off_c`` or
    ``crs._off_d``."""
    if dig_stream.is_cuda:
        return _launch(crs, dig_stream, base_off, t_used)
    if dig_stream.device.type == "cpu":
        return cd_sum_plain(crs, dig_stream, base_off, t_used)
    raise ValueError(f"no C/D kernel for device {dig_stream.device}")


def cd_sum_plain(crs, dig_stream: torch.Tensor, base_off: int,
                 t_used: int) -> torch.Tensor:
    p = crs.params
    n_tri = dig_stream.shape[0]
    dev = dig_stream.device

    def draw(l0: int, l1: int) -> torch.Tensor:
        lin = torch.arange(l0, l1, device=dev)
        oc = (lin // t_used) * p.t_1 + lin % t_used
        row = torch.arange(p.kappa_2, device=dev)
        c = torch.arange(p.d, device=dev)
        offs = (base_off + oc[None, :, None] * (p.kappa_2 * p.d)
                + row[:, None, None] * p.d + c[None, None, :])
        return crs.draw(offs)

    dig = dig_stream.reshape(1, n_tri * t_used, p.d)
    return ring_stream_plain(draw, dig, p.kappa_2, p.q)[0]


def _launch(crs, dig_stream: torch.Tensor, base_off: int,
            t_used: int) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    n_tri = dig_stream.shape[0]
    cuda_lib.require_cuda_operand(dig_stream, "dig_stream",
                                  (n_tri, t_used, p.d))
    check_big_operand(dig_stream, p.q, "dig_stream")
    L = n_tri * t_used
    if L >= 1 << 31 or p.kappa_2 * p.d >= 1 << 31:
        raise ValueError("C/D shape beyond the kernel's int32 indexing")
    splits = launch_shape(p.kappa_2, 1, L)
    part = torch.empty((splits, 1, p.kappa_2, p.d), dtype=torch.int64,
                       device=dig_stream.device)
    out = torch.empty((p.kappa_2, p.d), dtype=torch.int64,
                      device=dig_stream.device)
    lib = cuda_lib.load().lib
    err = lib.cd_sum_launch(
        dig_stream.data_ptr(), part.data_ptr(), out.data_ptr(), L, t_used,
        p.t_1, p.kappa_2, p.q, barrett_m(p.q), base_off, crs.key[0],
        crs.key[1], splits,
        cuda_lib.stream_ptr(dig_stream.device))
    cuda_lib.check(err)
    (KERNEL_BIG if is_big(p.q) else KERNEL).launches += 1
    return out

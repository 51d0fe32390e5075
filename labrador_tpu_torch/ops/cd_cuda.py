"""The C/D triangle sums sum_lin M_lin[row] (*) dig_lin: the CUDA kernel
(``csrc/cd.cu``) and its plain PyTorch version.

Replaces ``labrador_tpu/ops/cd_pallas.py`` (``cd_sum_pallas``), both its
branches: small q, and the 2^32-scale modulus (signed digits, launches
counted in ``KERNEL_BIG``).  The u1 C-term (M = C, g digits of base b_2,
t_used = t_2) and u2 (M = D, h digits of base b_1, t_used = t_1).  The
column vector of stream entry lin = tri * t_used + k sits at base + oc *
kappa_2 * d with oc = tri * t_1 + k — the t_1 multiplier also for C
(``structs.rs:106``).

The kernel is the u1 B-term's int8 tensor-core stream kernel
(``csrc/mma_stream.cuh``) with the C/D offset: ``digit_limbs`` of the
digit base, as the Pallas kernel counts them, the same in-kernel digit
check, raised after the launch, and launch shape (``ops/u1_cuda.py``).
The range mode (``length`` given) sums over the stream entries l0 .. l0 +
length - 1 only, one shard of the (tri, k) stream on a (dp, rows) mesh,
and returns that shard's partial (zeros for an empty range, with no
launch); its launches count in ``KERNEL_RANGE`` / ``KERNEL_RANGE_BIG``.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .ring_stream import barrett_m, check_q, ring_stream_plain
from .u1_cuda import (check_limb_mode, digit_limbs, launch_shape,
                      raise_if_flagged)
from .zq import is_big

KERNEL = cuda_lib.KernelInfo(
    name="cd_sum",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:183")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="cd_sum_bigq",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:128")
KERNEL_RANGE = cuda_lib.KernelInfo(
    name="cd_sum_range",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:183")
KERNEL_RANGE_BIG = cuda_lib.KernelInfo(
    name="cd_sum_range_bigq",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:128")


def cd_sum(crs, dig_stream: torch.Tensor, base_off: int, t_used: int,
           digit_base: int = 0, l0: int = 0,
           length: int | None = None) -> torch.Tensor:
    """(kappa_2, d) mod q for dig_stream (n_tri, t_used, d) digits
    (residues mod q, or signed at big q); base_off is ``crs._off_c`` or
    ``crs._off_d``; digit_base bounds the digits, |digit| <= digit_base //
    2 (b_2 for C; the default 0 means b_1, the D-term's, as in the Pallas
    kernel).  With ``length`` (the range mode): the partial over the
    stream entries lin = l0 .. l0 + length - 1 (lin = tri * t_used + k)."""
    if dig_stream.is_cuda:
        return _launch(crs, dig_stream, base_off, t_used, digit_base, l0,
                       length)
    if dig_stream.device.type == "cpu":
        return cd_sum_plain(crs, dig_stream, base_off, t_used, l0, length)
    raise ValueError(f"no C/D kernel for device {dig_stream.device}")


def _local_digits(dig_stream: torch.Tensor, l0: int,
                  length: int | None) -> torch.Tensor:
    """(length, d): the stream entries l0 .. l0 + length - 1 (all without
    a range); raises on a range outside the stream."""
    flat = dig_stream.reshape(-1, dig_stream.shape[-1])
    if length is None:
        return flat
    if l0 < 0 or length < 0 or l0 + length > flat.shape[0]:
        raise ValueError(f"stream entries {l0} .. {l0 + length} outside "
                         f"the {flat.shape[0]} of the stream")
    return flat[l0:l0 + length]


def cd_sum_plain(crs, dig_stream: torch.Tensor, base_off: int, t_used: int,
                 l0: int = 0, length: int | None = None) -> torch.Tensor:
    p = crs.params
    dev = dig_stream.device
    dig = _local_digits(dig_stream, l0, length)

    def draw(la: int, lb: int) -> torch.Tensor:
        lin = torch.arange(l0 + la, l0 + lb, device=dev)
        oc = (lin // t_used) * p.t_1 + lin % t_used
        row = torch.arange(p.kappa_2, device=dev)
        c = torch.arange(p.d, device=dev)
        offs = (base_off + oc[None, :, None] * (p.kappa_2 * p.d)
                + row[:, None, None] * p.d + c[None, None, :])
        return crs.draw(offs)

    if not dig.shape[0]:
        return torch.zeros((p.kappa_2, p.d), dtype=torch.int64, device=dev)
    return ring_stream_plain(draw, dig[None], p.kappa_2, p.q)[0]


def stream_digit_limbs(crs, digit_base: int = 0) -> int:
    """The kernel's digit-limb count for digits of base digit_base (b_1
    when 0), as the Pallas kernel counts them; raises if the kernel has no
    such mode."""
    p = crs.params
    n_limbs = digit_limbs(digit_base or p.b_1)
    check_limb_mode(p.q, n_limbs)
    return n_limbs


def _launch(crs, dig_stream: torch.Tensor, base_off: int, t_used: int,
            digit_base: int, l0: int, length: int | None) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    n_tri = dig_stream.shape[0]
    cuda_lib.require_cuda_operand(dig_stream, "dig_stream",
                                  (n_tri, t_used, p.d))
    n_limbs = stream_digit_limbs(crs, digit_base)
    if n_tri * t_used >= 1 << 31 or p.kappa_2 * p.d >= 1 << 31:
        raise ValueError("C/D shape beyond the kernel's int32 indexing")
    dig = _local_digits(dig_stream, l0, length)
    L = dig.shape[0]
    if not L:
        return torch.zeros((p.kappa_2, p.d), dtype=torch.int64,
                           device=dig.device)
    tiles, groups, splits, l_per_split = launch_shape(p.kappa_2, L)
    part = torch.empty((splits, p.kappa_2, p.d), dtype=torch.int64,
                       device=dig_stream.device)
    out = torch.empty((p.kappa_2, p.d), dtype=torch.int64,
                      device=dig_stream.device)
    bad = torch.empty((1,), dtype=torch.int32, device=dig_stream.device)
    lib = cuda_lib.load().lib
    err = lib.cd_sum_launch(
        dig.data_ptr(), part.data_ptr(), out.data_ptr(), bad.data_ptr(), L,
        l0, t_used, p.t_1, p.kappa_2, p.q, barrett_m(p.q), base_off,
        crs.key[0], crs.key[1], n_limbs, tiles, groups, splits, l_per_split,
        cuda_lib.stream_ptr(dig_stream.device))
    cuda_lib.check(err)
    if length is not None:
        (KERNEL_RANGE_BIG if is_big(p.q) else KERNEL_RANGE).launches += 1
    else:
        (KERNEL_BIG if is_big(p.q) else KERNEL).launches += 1
    raise_if_flagged(bad, dig, p.q, n_limbs)
    return out

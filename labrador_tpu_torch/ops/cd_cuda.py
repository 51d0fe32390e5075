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
For a ``crs.MaterializedCRS`` the kernel reads the column vectors from its
table, 0 past its end (the table mode, small q only, whole and ranged,
launches counted in ``KERNEL_TABLE``); ``ring_stream.entry_table``
decides.  For a ``crs.CRSBatch`` of B Threefry CRSs the stream leads with
B and the batch mode sums every instance in one launch (launches in
``KERNEL_BATCH`` / ``KERNEL_BATCH_BIG``, or in the range infos with
``length``: every instance takes the same range), the instances' digits
read in place at their stride, with one device sync for every
instance's digit flag.
"""

from __future__ import annotations

import sys

import torch

from . import cuda_lib
from .ring_stream import (barrett_m, check_q, device_keys, entry_table,
                          instances, ring_stream_plain)
from .u1_cuda import (check_limb_mode, digit_limbs, launch_shape,
                      raise_if_flagged)

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
KERNEL_TABLE = cuda_lib.KernelInfo(
    name="cd_sum_table",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:183")
KERNEL_BATCH = cuda_lib.KernelInfo(
    name="cd_sum_batch",
    source="labrador_tpu_torch/csrc/cd.cu",
    replaces="labrador_tpu/ops/cd_pallas.py:183")
KERNEL_BATCH_BIG = cuda_lib.KernelInfo(
    name="cd_sum_batch_bigq",
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
    stream entries lin = l0 .. l0 + length - 1 (lin = tri * t_used + k).
    For a ``crs.CRSBatch`` of B CRSs: dig_stream (B, n_tri, t_used, d) ->
    (B, kappa_2, d), instance b summed with ``crs[b]``."""
    if dig_stream.is_cuda:
        return _launch(crs, dig_stream, base_off, t_used, digit_base, l0,
                       length)
    if dig_stream.device.type == "cpu":
        return cd_sum_plain(crs, dig_stream, base_off, t_used, l0, length)
    raise ValueError(f"no C/D kernel for device {dig_stream.device}")


def _check_instances(crs, dig_stream: torch.Tensor) -> None:
    """A batch's stream leads with its instances; a single CRS's has no
    instance axis."""
    B = instances(crs)
    if dig_stream.dim() != (3 if B is None else 4) \
            or (B is not None and dig_stream.shape[0] != B):
        raise ValueError(f"dig_stream of shape {tuple(dig_stream.shape)} "
                         + ("for one CRS: (n_tri, t_used, d)" if B is None
                            else f"for a batch of {B} CRSs: ({B}, n_tri, "
                                 f"t_used, d)"))


def _local_digits(dig_stream: torch.Tensor, l0: int,
                  length: int | None) -> torch.Tensor:
    """(..., length, d): the stream entries l0 .. l0 + length - 1 (all
    without a range) of each instance, a view; raises on a range outside
    the stream."""
    flat = dig_stream.reshape(dig_stream.shape[:-3] + (-1,
                                                       dig_stream.shape[-1]))
    if length is None:
        return flat
    total = flat.shape[-2]
    if l0 < 0 or length < 0 or l0 + length > total:
        raise ValueError(f"stream entries {l0} .. {l0 + length} outside "
                         f"the {total} of the stream")
    return flat[..., l0:l0 + length, :]


def cd_sum_plain(crs, dig_stream: torch.Tensor, base_off: int, t_used: int,
                 l0: int = 0, length: int | None = None) -> torch.Tensor:
    p = crs.params
    dev = dig_stream.device
    _check_instances(crs, dig_stream)
    dig = _local_digits(dig_stream, l0, length)

    def draw(la: int, lb: int) -> torch.Tensor:
        lin = torch.arange(l0 + la, l0 + lb, device=dev)
        oc = (lin // t_used) * p.t_1 + lin % t_used
        row = torch.arange(p.kappa_2, device=dev)
        c = torch.arange(p.d, device=dev)
        offs = (base_off + oc[None, :, None] * (p.kappa_2 * p.d)
                + row[:, None, None] * p.d + c[None, None, :])
        return crs.draw(offs)

    if not dig.shape[-2]:
        return torch.zeros(dig.shape[:-2] + (p.kappa_2, p.d),
                           dtype=torch.int64, device=dev)
    return ring_stream_plain(draw, dig[..., None, :, :], p.kappa_2,
                             p.q)[..., 0, :, :]


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
    table = entry_table(crs, dig_stream.device)
    _check_instances(crs, dig_stream)
    dig = _local_digits(dig_stream, l0, length)
    n_tri = dig_stream.shape[-3]
    cuda_lib.require_cuda_operand(dig_stream, "dig_stream",
                                  dig_stream.shape[:-3] + (n_tri, t_used,
                                                           p.d))
    batch = instances(crs)
    B = batch or 1
    n_limbs = stream_digit_limbs(crs, digit_base)
    if n_tri * t_used >= 1 << 31 or p.kappa_2 * p.d >= 1 << 31 \
            or B > 65535:
        raise ValueError("C/D shape beyond the kernel's int32 indexing")
    L = dig.shape[-2]
    if not L:
        return torch.zeros(dig.shape[:-2] + (p.kappa_2, p.d),
                           dtype=torch.int64, device=dig.device)
    tiles, groups, splits, l_per_split = launch_shape(p.kappa_2, L, B)
    part = torch.empty((splits, B, p.kappa_2, p.d), dtype=torch.int64,
                       device=dig_stream.device)
    out = torch.empty(dig.shape[:-2] + (p.kappa_2, p.d), dtype=torch.int64,
                      device=dig_stream.device)
    bad = torch.empty((B,), dtype=torch.int32, device=dig_stream.device)
    # each instance's local digits in place: row stride d, instance stride
    # the whole stream's
    inst_stride = dig.stride(0) if batch is not None else 0
    lib = cuda_lib.load().lib
    stream = cuda_lib.stream_ptr(dig_stream.device)
    ranged = length is not None
    if table is not None:
        err = lib.cd_sum_table_launch(
            dig.data_ptr(), part.data_ptr(), out.data_ptr(), bad.data_ptr(),
            L, l0, t_used, p.t_1, p.kappa_2, p.q, base_off, table.data_ptr(),
            table.numel(), n_limbs, tiles, groups, splits, l_per_split,
            stream)
        info = KERNEL_TABLE
    else:
        err = lib.cd_sum_launch(
            dig.data_ptr(), part.data_ptr(), out.data_ptr(), bad.data_ptr(),
            L, l0, t_used, p.t_1, p.kappa_2, p.q, barrett_m(p.q), base_off,
            device_keys(crs, dig.device).data_ptr(), B, inst_stride,
            n_limbs, tiles, groups, splits, l_per_split, stream)
        info = cuda_lib.launch_info(sys.modules[__name__], p.q, ranged,
                                    batch is not None)
    cuda_lib.check(err)
    info.launches += 1
    raise_if_flagged(bad, dig, p.q, n_limbs, batch is not None)
    return out

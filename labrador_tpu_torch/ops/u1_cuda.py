"""The u1 B-term sum_{m, col} B_m[row, col] (*) t_m[col]: the CUDA kernel
(``csrc/u1.cu``) and its plain PyTorch version.

Replaces ``labrador_tpu/ops/u1_pallas.py`` (``u1_bterm_pallas``).  The
r * t_1 virtual B matrices (kappa_1, kappa, d) sit at
off_b + m * kappa_1 * kappa (no factor d: the reference's stride quirk,
``structs.rs:82``) with row stride kappa * d; m = i * t_1 + k walks the
t digits in the order of the JAX package's stream.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .ring_stream import check_small_q, launch_shape, ring_stream_plain

KERNEL = cuda_lib.KernelInfo(
    name="u1_bterm",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")


def _stream(t_dig: torch.Tensor, p) -> torch.Tensor:
    """(t_1, r, kappa, d) digits -> (1, r * t_1 * kappa, d) stream in B
    order (m = i * t_1 + k, then col)."""
    return torch.swapaxes(t_dig, 0, 1).reshape(1, p.r * p.t_1 * p.kappa,
                                                p.d).contiguous()


def u1_bterm(crs, t_dig: torch.Tensor) -> torch.Tensor:
    """(kappa_1, d) mod q for t_dig (t_1, r, kappa, d) residues mod q."""
    if t_dig.is_cuda:
        return _launch(crs, t_dig)
    if t_dig.device.type == "cpu":
        return u1_bterm_plain(crs, t_dig)
    raise ValueError(f"no u1 kernel for device {t_dig.device}")


def u1_bterm_plain(crs, t_dig: torch.Tensor) -> torch.Tensor:
    p = crs.params
    kd = p.kappa * p.d

    def draw(l0: int, l1: int) -> torch.Tensor:
        # l = m * kappa + col: offsets off_b + m*k1*k + row*k*d + col*d + c
        lin = torch.arange(l0, l1, device=t_dig.device)
        col_off = (lin // p.kappa) * (p.kappa_1 * p.kappa) \
            + (lin % p.kappa) * p.d
        row_off = torch.arange(p.kappa_1, device=t_dig.device) * kd
        c = torch.arange(p.d, device=t_dig.device)
        offs = (crs._off_b + row_off[:, None, None] + col_off[None, :, None]
                + c[None, None, :])
        return crs.draw(offs)

    return ring_stream_plain(draw, _stream(t_dig, p), p.kappa_1, p.q)[0]


def _launch(crs, t_dig: torch.Tensor) -> torch.Tensor:
    p = crs.params
    check_small_q(p.q, p.d)
    cuda_lib.require_cuda_operand(t_dig, "t_dig", (p.t_1, p.r, p.kappa, p.d))
    m_total = p.r * p.t_1
    L = m_total * p.kappa
    if L >= 1 << 31 or p.kappa_1 * p.d >= 1 << 31:
        raise ValueError("u1 shape beyond the kernel's int32 indexing")
    stream = _stream(t_dig, p)
    splits = launch_shape(p.kappa_1, 1, L)
    part = torch.empty((splits, 1, p.kappa_1, p.d), dtype=torch.int64,
                       device=t_dig.device)
    out = torch.empty((p.kappa_1, p.d), dtype=torch.int64,
                      device=t_dig.device)
    lib = cuda_lib.load().lib
    err = lib.u1_bterm_launch(
        stream.data_ptr(), part.data_ptr(), out.data_ptr(), m_total, p.kappa,
        p.kappa_1, p.q, crs._off_b, crs.key[0], crs.key[1], splits,
        cuda_lib.stream_ptr(t_dig.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out

"""Batched negacyclic product in Rq: the CUDA kernel (``csrc/polymul.cu``)
and its plain PyTorch versions.

Replaces ``labrador_tpu/ops/ntt_pallas.py`` (``negacyclic_polymul_pallas``
and ``negacyclic_polymul_pallas_bhat``).  Both variants take int64
coefficient tensors (..., d) of residues in [0, q) or small signed values
(|x| < q) and return residues in [0, q):

* ``negacyclic_polymul(a, b, plan)``: a (*) b; the recursion's ring
  products (``recursion._ring_mul_modq``) are this function, so they run
  this kernel on the card;
* ``negacyclic_polymul_bhat(a, bhat, plan)``: a (*) b with b given in the
  evaluation domain, bhat (P,) + shape of per-prime residues.

The route is chosen by q alone: at q <= P_MAX the kernel on CUDA tensors
and the plain version on CPU tensors; at big q the plain version's CRT
transforms in torch ops on any device, as the JAX package's big-q ring
products are XLA ops.

Both operands broadcast to their common shape (numpy rules on the
coefficient shape; bhat's leading axis is the prime axis), unlike the
Pallas version, which broadcasts b to a's shape only.  A fixed operand is
passed with one row, e.g. bhat (P, 1, d) against a (N, d); the kernel then
reads that row for every product instead of a materialised copy.  The
wrappers launch the kernel for CUDA tensors and take the plain version only
for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import ntt as ntt_ops
from .modmath import P_MAX

KERNEL = cuda_lib.KernelInfo(
    name="negacyclic_polymul",
    source="labrador_tpu_torch/csrc/polymul.cu",
    replaces="labrador_tpu/ops/ntt_pallas.py:270")


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor,
                       plan) -> torch.Tensor:
    """Exact a (*) b mod q for coefficient tensors (..., d)."""
    # Big q takes the CRT transforms on any device: kernel 1 is small-q
    # only in the JAX package too (ntt_pallas.py:304, 328 assert q <=
    # P_MAX), whose big-q ring products are XLA transforms; this is their
    # counterpart, not a stand-in for the kernel.
    if plan.q > P_MAX:
        return negacyclic_polymul_plain(a, b, plan)
    if a.is_cuda or b.is_cuda:
        return _launch_coef(a, b, plan)
    if a.device.type == b.device.type == "cpu":
        return negacyclic_polymul_plain(a, b, plan)
    raise ValueError(f"no polymul kernel for devices {a.device}, {b.device}")


def negacyclic_polymul_plain(a: torch.Tensor, b: torch.Tensor,
                             plan) -> torch.Tensor:
    """a (*) b mod q by the CRT transforms in torch ops (``ops.ntt``), on
    any device: the plain version of the coefficient kernel, and the big-q
    route."""
    return ntt_ops.ntt_inv_modq(ntt_ops.eval_mul(
        ntt_ops.ntt_fwd(a, plan), ntt_ops.ntt_fwd(b, plan), plan), plan)


def negacyclic_polymul_bhat(a: torch.Tensor, bhat: torch.Tensor,
                            plan) -> torch.Tensor:
    """a (*) b mod q for a (..., d) coefficients and b's transform bhat
    (P,) + (..., d); the result has the broadcast shape.  Routed by q as
    ``negacyclic_polymul``."""
    if plan.q > P_MAX:
        return negacyclic_polymul_bhat_plain(a, bhat, plan)
    if a.is_cuda or bhat.is_cuda:
        return _launch_bhat(a, bhat, plan)
    if a.device.type == bhat.device.type == "cpu":
        return negacyclic_polymul_bhat_plain(a, bhat, plan)
    raise ValueError(f"no polymul kernel for devices {a.device}, "
                     f"{bhat.device}")


def negacyclic_polymul_bhat_plain(a: torch.Tensor, bhat: torch.Tensor,
                                  plan) -> torch.Tensor:
    """``negacyclic_polymul_plain`` against a transformed operand."""
    return ntt_ops.ntt_inv_modq(ntt_ops.eval_mul(
        ntt_ops.ntt_fwd(a, plan), bhat, plan), plan)


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

def _check_plan(plan) -> None:
    if plan.q > P_MAX:
        raise ValueError("the polymul kernel takes q <= P_MAX; big-q ring "
                         "products take the CRT route")
    if plan.d != 64:
        raise ValueError("the polymul kernel is built for d = 64")


def _rows(x: torch.Tensor, shape: tuple, name: str, lead: tuple = ()):
    """x as contiguous rows of d for a broadcast to lead + shape, and the
    row stride the kernel reads them with: 0 where x holds one row per
    leading index (a fixed operand), else d."""
    d = shape[-1]
    if x.shape[len(lead):-1].numel() == 1:
        rows, stride = x.reshape(lead + (1, d)), 0
    else:
        rows, stride = torch.broadcast_to(x, lead + shape).reshape(
            lead + (-1, d)), d
    rows = rows.contiguous()
    cuda_lib.require_cuda_operand(rows, name, rows.shape)
    return rows, stride


def _launch_coef(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    _check_plan(plan)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    if shape[-1] != plan.d:
        raise ValueError(f"operands of shape {tuple(a.shape)}, "
                         f"{tuple(b.shape)} are not rows of d = {plan.d}")
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel() // plan.d
    if n == 0:
        return out
    a2, a_stride = _rows(a, shape, "a")
    b2, b_stride = _rows(b, shape, "b")
    err = cuda_lib.load().lib.polymul_coef_launch(
        a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, a_stride, b_stride,
        plan.q, cuda_lib.stream_ptr(a.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out


def _kernel_tables(plan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(V | W as (2, P, d, d) int32, Garner constants int64) on ``device``,
    cached on the plan: primes | garner_inv (P, P) | m_half_digits |
    prefix_mod_q | m_mod_q, the layout csrc/polymul.cu reads."""
    t = plan.tensors(device)
    if "polymul_vw" not in t:
        t["polymul_vw"] = torch.stack([t["V"], t["W"]]).to(
            torch.int32).contiguous()
        consts = [*plan.primes, *plan.garner_inv.reshape(-1).tolist(),
                  *plan.m_half_digits, *plan.prefix_mod_q, plan.m_mod_q]
        t["polymul_consts"] = torch.tensor(
            [int(c) for c in consts], dtype=torch.int64, device=device)
    return t["polymul_vw"], t["polymul_consts"]


def _launch_bhat(a: torch.Tensor, bhat: torch.Tensor, plan) -> torch.Tensor:
    _check_plan(plan)
    P = plan.n_primes
    if bhat.ndim < 2 or bhat.shape[0] != P:
        raise ValueError(f"bhat of shape {tuple(bhat.shape)} lacks the "
                         f"leading prime axis of {P}")
    shape = tuple(torch.broadcast_shapes(a.shape, bhat.shape[1:]))
    if shape[-1] != plan.d:
        raise ValueError(f"operands are not rows of d = {plan.d}")
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel() // plan.d
    if n == 0:
        return out
    a2, a_stride = _rows(a, shape, "a")
    b2, b_stride = _rows(bhat, shape, "bhat", lead=(P,))
    vw, consts = _kernel_tables(plan, a.device)
    err = cuda_lib.load().lib.polymul_bhat_launch(
        a2.data_ptr(), b2.data_ptr(), vw.data_ptr(), consts.data_ptr(),
        out.data_ptr(), n, a_stride, b_stride, b2.shape[1] * plan.d, P,
        plan.q, cuda_lib.stream_ptr(a.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out

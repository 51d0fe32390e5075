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
coefficient kernel takes any broadcast that two row strides per operand
describe (``row_geometry``), e.g. the fold's (r, 1, d) x (1, r, d), with
no copy.  The wrappers launch the kernel for CUDA tensors and take the
plain version only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
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
    row stride the bhat kernel reads them with: 0 where x holds one row per
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


INT32_MAX = (1 << 31) - 1


@functools.cache
def coef_consts(q: int) -> tuple[int, int, int, int]:
    """The coefficient kernel's constants at q: (F, S, floor(2^32 / q),
    floor((2^64 - 1) / q)).  F, the flush length, is the longest of 64, 32,
    16, 8 terms whose centred products (each at most h^2, h = q // 2) sum
    exactly in int32 and whose sum shifted by S, the least multiple of q
    not below F h^2, stays below 2^32 (barrett32's range); the launcher
    checks the same bounds."""
    h = q // 2
    for flush in (64, 32, 16, 8):
        fh2 = flush * h * h
        if fh2 <= INT32_MAX and 2 * fh2 + q <= 1 << 32:
            return flush, -(-fh2 // q) * q, (1 << 32) // q, \
                ((1 << 64) - 1) // q
    raise ValueError(f"no flush length for q = {q}")


def row_geometry(lead: tuple, sa: list, sb: list) -> tuple | None:
    """How the coefficient kernel reads a and b broadcast over the leading
    shape ``lead``, given their element strides sa, sb over ``lead`` (0 on
    a broadcast axis): (n_inner, a_outer, a_inner, b_outer, b_inner) such
    that output row r = ro n_inner + ri reads a's row at ro a_outer + ri
    a_inner and b's likewise; None where two strides do not describe it.
    Axes of size 1 drop out, and neighbouring axes merge where both
    operands step through them as through one."""
    axes: list = []
    for size, x, y in zip(lead, sa, sb):
        if size == 1:
            continue
        if axes and axes[-1][1] == x * size and axes[-1][2] == y * size:
            axes[-1] = (axes[-1][0] * size, x, y)
        else:
            axes.append((size, x, y))
    if len(axes) > 2:
        return None
    if len(axes) == 2:
        (_, ao, bo), (n_inner, ai, bi) = axes
        return n_inner, ao, ai, bo, bi
    return (axes[0][0], 0, axes[0][1], 0, axes[0][2]) if axes else \
        (1, 0, 0, 0, 0)


def _kernel_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x itself where the kernel can read its rows (d contiguous
    coefficients, 16-byte aligned, even row strides), else a contiguous
    copy of its rows."""
    if x.shape[-1] != d:
        return torch.broadcast_to(x, x.shape[:-1] + (d,)).contiguous()
    if x.data_ptr() % 16 == 0 and (x.is_contiguous() or (
            x.stride(-1) == 1 and all(
                st % 2 == 0 for st, size in zip(x.stride()[:-1], x.shape)
                if size > 1))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _lead_strides(x: torch.Tensor, lead: tuple) -> list:
    """x's element strides over the leading shape ``lead`` it broadcasts
    to: 0 on an axis that x lacks or holds once."""
    k = x.dim() - 1
    st = x.stride()
    return [0] * (len(lead) - k) + [
        st[i] if x.shape[i] != 1 else 0 for i in range(k)]


def coef_operands(a: torch.Tensor, b: torch.Tensor, shape: tuple):
    """(a', b', (n_inner, a_outer, a_inner, b_outer, b_inner)): the
    tensors whose data the kernel reads for a and b broadcast to
    ``shape``, and the row geometry it reads them with.  a' is a itself
    (no copy) where its rows are aligned and ``row_geometry`` describes
    the broadcast (every shape of the main path and config 2); else a copy
    of a, or at worst of its broadcast."""
    lead = shape[:-1]
    a, b = _kernel_rows(a, shape[-1]), _kernel_rows(b, shape[-1])
    geom = row_geometry(lead, _lead_strides(a, lead), _lead_strides(b, lead))
    if geom is None:
        a = torch.broadcast_to(a, shape).contiguous()
        b = torch.broadcast_to(b, shape).contiguous()
        geom = row_geometry(lead, _lead_strides(a, lead),
                            _lead_strides(b, lead))
    return a, b, geom


def _launch_coef(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    _check_plan(plan)
    for x, name in ((a, "a"), (b, "b")):
        if not x.is_cuda or x.dtype != torch.int64:
            raise ValueError(f"{name} must be an int64 CUDA tensor, got "
                             f"{x.dtype} on {x.device}")
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    if shape[-1] != plan.d:
        raise ValueError(f"operands of shape {tuple(a.shape)}, "
                         f"{tuple(b.shape)} are not rows of d = {plan.d}")
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel() // plan.d
    if n == 0:
        return out
    a, b, geom = coef_operands(a, b, shape)
    err = cuda_lib.load().lib.polymul_coef_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, *geom, plan.q,
        *coef_consts(plan.q), cuda_lib.stream_ptr(a.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out


def bhat_tables(plan) -> np.ndarray:
    """The transforms V_p and W_p as the bhat kernel's B fragments: uint32
    words (2, P, 2, 8, 2, 32, 2) over transform (V, W), prime, k-step s,
    n-tile, limb (low byte, high byte of the residue), lane (g = lane / 4,
    t = lane % 4) and fragment register (b0, b1).  Register b_i holds in
    byte j the limb of T[perm[s][16 i + 4 t + j]][8 nt + g]: the rows in
    the kernel's K order (``bhat_k_order``)."""
    P = plan.n_primes
    perm = bhat_k_order()
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((2, P, 2, 8, 2, 32, 2), np.int64)
    for ti, table in enumerate((plan.V, plan.W)):
        for s in range(2):
            rows_t = np.asarray(table, np.int64)[:, perm[s], :]
            for limb in range(2):
                lt = (rows_t >> (8 * limb)) & 255
                for nt in range(8):
                    for bi in range(2):
                        k = 16 * bi + 4 * t[:, None] + np.arange(4)[None, :]
                        vals = lt[:, k, (8 * nt + g)[:, None]]  # (P, 32, 4)
                        out[ti, :, s, nt, limb, :, bi] = (
                            vals << (8 * np.arange(4))).sum(-1)
    return out.astype(np.uint32)


def bhat_k_order() -> np.ndarray:
    """(2, 32): the column of a (and of y) at logical k of k-step s:
    within a k-step, k = 16 hp + 4 t + 2 pp + e is column 32 s + 16 hp +
    8 pp + 2 t + e, so a lane's A fragment holds the columns of its C
    fragments (``csrc/polymul.cu``)."""
    k = np.arange(32)
    hp, t, pp, e = k // 16, (k % 16) // 4, (k % 4) // 2, k % 2
    return np.stack([32 * s + 16 * hp + 8 * pp + 2 * t + e for s in (0, 1)])


def bhat_consts(plan) -> list[int]:
    """The bhat kernel's constants: primes | floor(2^32 / p) (its 32-bit
    Barrett) | floor((2^64 - 1) / p) (64-bit, for operands outside
    [-p, p)) | garner_inv (P, P) | m_half_digits | prefix_mod_q | m_mod_q |
    q | floor(2^32 / q)."""
    pr = [int(p) for p in plan.primes]
    return [*pr, *[(1 << 32) // p for p in pr],
            *[((1 << 64) - 1) // p for p in pr],
            *[int(x) for x in plan.garner_inv.reshape(-1)],
            *[int(x) for x in plan.m_half_digits],
            *[int(x) for x in plan.prefix_mod_q], int(plan.m_mod_q),
            plan.q, (1 << 32) // plan.q]


def _kernel_tables(plan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(``bhat_tables`` as int32 words, ``bhat_consts`` int64) on
    ``device``, cached on the plan."""
    t = plan.tensors(device)
    if "bhat_tables" not in t:
        t["bhat_tables"] = torch.from_numpy(
            bhat_tables(plan).view(np.int32)).to(device)
        t["bhat_consts"] = torch.tensor(bhat_consts(plan), dtype=torch.int64,
                                        device=device)
    return t["bhat_tables"], t["bhat_consts"]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned (the kernel
    reads pairs of int64)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_bhat(a: torch.Tensor, bhat: torch.Tensor, plan) -> torch.Tensor:
    _check_plan(plan)
    P = plan.n_primes
    if bhat.ndim < 2 or bhat.shape[0] != P:
        raise ValueError(f"bhat of shape {tuple(bhat.shape)} lacks the "
                         f"leading prime axis of {P}")
    if not all((1 << 14) < p < (1 << 15) for p in plan.primes):
        raise ValueError("the bhat kernel's Garner bounds need every CRT "
                         "prime in (2^14, 2^15)")
    shape = tuple(torch.broadcast_shapes(a.shape, bhat.shape[1:]))
    if shape[-1] != plan.d:
        raise ValueError(f"operands are not rows of d = {plan.d}")
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel() // plan.d
    if n == 0:
        return out
    a2, a_stride = _rows(a, shape, "a")
    b2, b_stride = _rows(bhat, shape, "bhat", lead=(P,))
    a2, b2 = _aligned(a2), _aligned(b2)
    tables, consts = _kernel_tables(plan, a.device)
    err = cuda_lib.load().lib.polymul_bhat_launch(
        a2.data_ptr(), b2.data_ptr(), tables.data_ptr(), consts.data_ptr(),
        out.data_ptr(), n, a_stride, b_stride, b2.shape[1] * plan.d, P,
        cuda_lib.stream_ptr(a.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out

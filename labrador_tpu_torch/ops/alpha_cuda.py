"""The alpha-contractions of a folded statement: sums over the rows of the
base CRS's A, B and C/D blocks weighted by alpha; the CUDA kernel
(``csrc/alpha.cu``) and its plain PyTorch version.

``recursion.FoldedState.phi_alpha_modq`` needs, with w alpha's part of a
block (residues in [0, q)),

* A: sum_rho w[rho] * A[rho, col] over the kappa rows -> (n, d);
* B: sum_rho w[rho] * B_m[rho, col] over the kappa_1 rows of every B_m, m
  = i * t_1 + k -> (r * t_1 * kappa, d), row m * kappa + col;
* C/D: sum_rho w[rho] * M_{tri,k}[rho] over the kappa_2 rows of the
  column vectors at base + (k + t_1 * tri) * kappa_2 * d (the t_1-stride
  quirk, ``structs.rs:106``) -> (n_tri * t_used, d), row tri * t_used + k.

Replaces no Pallas kernel: the JAX package contracts in XLA ops.  On CUDA
each call is one launch of the tensor-core stream kernel
(``csrc/mma_stream.cuh``, launch shape ``u1_cuda.launch_shape``) with the
CRS generated in registers and the weights taken as full residues (as many
signed limbs as the entries, ``u1_cuda.entry_limbs(q)``, which hold every
centred residue; no digit check, so no device sync); launches
count in ``KERNEL`` / ``KERNEL_BIG``.  Only a Threefry ``crs.CRS`` takes
the kernel: a folded statement's base CRS always is one.  Elsewhere the
plain version expands the entries a tile at a time in torch ops and
contracts them through the CRT transforms (``ops/ntt``), as the JAX
package does.
"""

from __future__ import annotations

import torch

from ..crs import CRS
from . import cuda_lib
from . import ntt as ntt_ops
from .modmath import mod_pos
from .ring_stream import barrett_m, check_q, device_keys
from .u1_cuda import launch_shape
from .zq import is_big

KERNEL = cuda_lib.KernelInfo(
    name="alpha_contract",
    source="labrador_tpu_torch/csrc/alpha.cu",
    replaces="none: labrador_tpu/recursion.py contracts in XLA ops")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="alpha_contract_bigq",
    source="labrador_tpu_torch/csrc/alpha.cu",
    replaces="none: labrador_tpu/recursion.py contracts in XLA ops")


# CRS entries the plain version expands per step (4 Mi: a step's
# evaluation-domain tile is P x 32 MiB of int64)
_STEP_COEFFS = 1 << 22


def _route(crs, w: torch.Tensor, L: int, rows: int, plain, entry: str,
           *shape) -> torch.Tensor:
    """Launch the kernel on CUDA (``_launch``), call ``plain()``
    elsewhere."""
    if w.is_cuda:
        return _launch(crs, w, L, rows, entry, *shape)
    return plain()


def alpha_a(crs, w: torch.Tensor) -> torch.Tensor:
    """sum_rho w[rho] * A[rho] -> (n, d) mod q, w (kappa, d)."""
    p = crs.params
    return _route(crs, w, p.kappa, p.n, lambda: alpha_a_plain(crs, w),
                  "alpha_a_launch", p.kappa, p.n)


def alpha_b(crs, w: torch.Tensor) -> torch.Tensor:
    """S_B[m, col] = sum_rho w[rho] * B_m[rho, col] -> (r * t_1 * kappa, d)
    mod q, w (kappa_1, d)."""
    p = crs.params
    m_total = p.r * p.t_1
    return _route(crs, w, p.kappa_1, m_total * p.kappa,
                  lambda: alpha_b_plain(crs, w), "alpha_b_launch", p.kappa_1,
                  m_total, p.kappa, crs._off_b)


def alpha_cd(crs, base_off: int, w: torch.Tensor,
             t_used: int) -> torch.Tensor:
    """S[tri, k] = sum_rho w[rho] * M_{tri,k}[rho] -> (n_tri * t_used, d)
    mod q, w (kappa_2, d); base_off is ``crs._off_c`` or ``crs._off_d``."""
    p = crs.params
    n_tri = p.r * (p.r + 1) // 2
    return _route(crs, w, p.kappa_2, n_tri * t_used,
                  lambda: alpha_cd_plain(crs, base_off, w, t_used),
                  "alpha_cd_launch", p.kappa_2, n_tri, t_used, p.t_1,
                  base_off)


def _contract_rows_hat(w_hat: torch.Tensor, m_hat: torch.Tensor,
                       plan) -> torch.Tensor:
    """sum_rho w[rho] * M[rho, col] in the eval domain:
    w_hat (P, R, d), m_hat (P, R, C, d) -> (P, C, d)."""
    return ntt_ops.eval_matmul(w_hat[:, None], m_hat, plan)[:, 0]


def alpha_a_plain(crs, w: torch.Tensor) -> torch.Tensor:
    p = crs.params
    plan = ntt_ops.plan_for(p)
    dev = w.device
    w_hat = ntt_ops.ntt_fwd(w, plan)
    tile = max(1, _STEP_COEFFS // (p.n * p.d))
    acc = torch.zeros((plan.n_primes, p.n, p.d), dtype=torch.int64,
                      device=dev)
    for r0 in range(0, p.kappa, tile):
        nrows = min(tile, p.kappa - r0)
        a_hat = ntt_ops.ntt_fwd(crs.a_rows_dyn(r0, nrows, device=dev), plan)
        acc = ntt_ops.eval_add(acc, _contract_rows_hat(
            w_hat[:, r0:r0 + nrows], a_hat, plan), plan)
    return ntt_ops.ntt_inv_modq(acc, plan)


def alpha_b_plain(crs, w: torch.Tensor) -> torch.Tensor:
    """One B matrix (or column tile of one) per step."""
    p = crs.params
    plan = ntt_ops.plan_for(p)
    dev = w.device
    w_hat = ntt_ops.ntt_fwd(w, plan)
    m_total = p.r * p.t_1
    cols = max(1, min(p.kappa, _STEP_COEFFS // (p.kappa_1 * p.d)))
    acc = torch.empty((plan.n_primes, m_total, p.kappa, p.d),
                      dtype=torch.int64, device=dev)
    for m in range(m_total):
        for c0 in range(0, p.kappa, cols):
            nc = min(cols, p.kappa - c0)
            b_hat = ntt_ops.ntt_fwd(
                crs.b_mat_dyn(m, col0=c0, ncols=nc, device=dev), plan)
            acc[:, m, c0:c0 + nc] = _contract_rows_hat(w_hat, b_hat, plan)
    return ntt_ops.ntt_inv_modq(acc, plan).reshape(m_total * p.kappa, p.d)


def alpha_cd_plain(crs, base_off: int, w: torch.Tensor,
                   t_used: int) -> torch.Tensor:
    """Triangle chunks of column vectors per step."""
    p = crs.params
    plan = ntt_ops.plan_for(p)
    dev = w.device
    w_hat = ntt_ops.ntt_fwd(w, plan)
    n_tri = p.r * (p.r + 1) // 2
    col = p.kappa_2 * p.d
    chunk = max(1, _STEP_COEFFS // (t_used * col))
    parts = []
    for tri0 in range(0, n_tri, chunk):
        nt = min(chunk, n_tri - tri0)
        grp = crs._expand_dyn(base_off, tri0, p.t_1 * col,
                              (nt, t_used, p.kappa_2, p.d),
                              (p.t_1 * col, col, p.d, 1), device=dev)
        mats_hat = ntt_ops.ntt_fwd(grp.reshape(nt * t_used, p.kappa_2, p.d),
                                   plan)                 # (P, m, k2, d)
        parts.append(ntt_ops.eval_matmul(mats_hat, w_hat[:, :, None, :],
                                         plan)[:, :, 0])
    return ntt_ops.ntt_inv_modq(torch.cat(parts, dim=1), plan)


def _launch(crs, w: torch.Tensor, L: int, rows: int, entry: str,
            *shape) -> torch.Tensor:
    """One launch of C entry point ``entry`` over a stream of L ring
    elements into (rows, d); ``shape`` the entry point's arguments between
    the output and q."""
    if type(crs) is not CRS:
        raise TypeError(f"the alpha-contraction kernel expands a Threefry "
                        f"crs.CRS from its key, not a {type(crs).__name__}")
    p = crs.params
    check_q(p.q, p.d)
    cuda_lib.require_cuda_operand(w, "w", (L, p.d))
    if rows * p.d >= 1 << 31:
        raise ValueError("alpha-contraction shape beyond the kernel's int32 "
                         "indexing")
    dev = w.device
    w = mod_pos(w, p.q)          # residues in [0, q): what the limbs hold
    tiles, groups, splits, l_per_split = launch_shape(rows, L)
    part = torch.empty((splits, rows, p.d), dtype=torch.int64, device=dev)
    out = torch.empty((rows, p.d), dtype=torch.int64, device=dev)
    err = getattr(cuda_lib.load().lib, entry)(
        w.data_ptr(), part.data_ptr(), out.data_ptr(), *shape, p.q,
        barrett_m(p.q), device_keys(crs, dev).data_ptr(), tiles, groups,
        splits, l_per_split, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err)
    (KERNEL_BIG if is_big(p.q) else KERNEL).launches += 1
    return out

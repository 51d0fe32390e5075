"""Shared prover/verifier protocol math (small q, single device).

Counterpart of ``labrador_tpu/protocol.py`` along its ``ctx=None`` branches.
The three CRS-consuming commitments go through the kernel wrappers
(``ops/ajtai_cuda``, ``ops/u1_cuda``, ``ops/cd_cuda``), as the JAX package
sends them through its Pallas kernels on the TPU; everything else is
eval-domain tensor algebra.
"""

from __future__ import annotations

import torch

from .ops import ntt as ntt_ops
from .ops import rq, zq
from .ops.ajtai_cuda import ajtai_commit as _ajtai_kernel
from .ops.cd_cuda import cd_sum
from .ops.decompose import decompose
from .ops.modmath import matmul_mod, mod_pos
from .ops.u1_cuda import u1_bterm
from .params import LabradorParams, _ceil_log


# ---------------------------------------------------------------------------
# First aggregation (proofgen.rs:189-289 / verification.rs:38-89)
# ---------------------------------------------------------------------------

def aggregate_a_pp(a_prime: torch.Tensor, psi: torch.Tensor,
                   q: int) -> torch.Tensor:
    """a''_k = sum_l psi_k[l] a'_l: (L, r, r, d), (ub, L) -> (ub, r, r, d)."""
    terms = mod_pos(psi[:, :, None, None, None] * a_prime[None], q)
    return mod_pos(torch.sum(terms, dim=1), q)


def sigma_inv_pi(pi: torch.Tensor, params: LabradorParams) -> torch.Tensor:
    """sigma^-1 on every JL row viewed as n ring elements:
    (r, 256, n*d) int8 -> (r, 256, n*d) mod q."""
    p = params
    polys = mod_pos(pi.to(torch.int64), p.q).reshape(p.r, 256, p.n, p.d)
    return rq.sigma_inv(polys, p.q).reshape(p.r, 256, p.n * p.d)


def aggregate_phi_pp(phi_prime: torch.Tensor, psi: torch.Tensor,
                     omega: torch.Tensor, pi_sigma: torch.Tensor,
                     params: LabradorParams) -> torch.Tensor:
    """phi''_k,i = sum_l psi_k[l] phi'_l,i + sum_j omega_k[j]
    sigma^-1(pi_i^(j)) -> (ub, r, n, d)."""
    p = params
    ub = omega.shape[0]
    lhs = mod_pos(torch.sum(
        mod_pos(psi[:, :, None, None, None] * phi_prime[None], p.q), dim=1),
        p.q)
    # omega (ub, 256) @ pi_sigma_i (256, n*d) for every i
    rhs = matmul_mod(omega[None], pi_sigma, p.q, p.q - 1, p.q - 1)
    rhs = torch.movedim(rhs, 0, 1).reshape(ub, p.r, p.n, p.d)
    return mod_pos(lhs + rhs, p.q)


def b_pp_from_witness(a_pp_hat, phi_pp_hat, s_hat, g_hat, plan):
    """b''_k = sum_ij a''_k,ij <s_i,s_j> + sum_i <phi''_k,i, s_i> -> (ub, d)."""
    ub, d = a_pp_hat.shape[1], a_pp_hat.shape[-1]
    P = plan.n_primes
    t1 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(a_pp_hat, g_hat[:, None], plan)
                            .reshape(P, ub, -1, d), plan, axis=2)
    t2 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(phi_pp_hat, s_hat[:, None], plan)
                            .reshape(P, ub, -1, d), plan, axis=2)
    return ntt_ops.ntt_inv_modq(ntt_ops.eval_add(t1, t2, plan), plan)


def b_pp_expected_const(omega, psi, projection, b_prime, q: int):
    """<omega_k, p> + sum_l psi_k[l] b'_l: the b'' constant-term check
    (verification.rs:515-551) -> (ub,)."""
    prod = mod_pos(torch.sum(mod_pos(omega * projection[None], q), dim=1), q)
    s = mod_pos(torch.sum(mod_pos(psi * b_prime[None], q), dim=1), q)
    return mod_pos(prod + s, q)


# ---------------------------------------------------------------------------
# Second aggregation (proofgen.rs:295-314 / verification.rs:96-148)
# ---------------------------------------------------------------------------

def phi_weighted_hat(w_hat, phi_hat, plan):
    """sum_k w_k * phi_k in the eval domain: (P, K, d), (P, K, ..., d)."""
    extra = phi_hat.ndim - 3
    wb = w_hat.reshape(w_hat.shape[:2] + (1,) * extra + (w_hat.shape[-1],))
    return ntt_ops._mod_sum_p(ntt_ops.eval_mul(wb, phi_hat, plan), plan,
                              axis=1)


def phi_final_hat(alpha_hat, beta_hat, phi_hat, phi_pp_hat, plan):
    """phi_i = sum_k alpha_k phi_k,i + sum_k beta_k phi''_k,i (eval)."""
    return ntt_ops.eval_add(phi_weighted_hat(alpha_hat, phi_hat, plan),
                            phi_weighted_hat(beta_hat, phi_pp_hat, plan),
                            plan)


def a_final_hat(alpha_hat, beta_hat, a_hat, a_pp_hat, plan):
    """a_ij = sum_k alpha_k a_k,ij + sum_k beta_k a''_k,ij (eval)."""
    return phi_final_hat(alpha_hat, beta_hat, a_hat, a_pp_hat, plan)


def b_final(alpha_hat, beta_hat, b_hat, b_pp_hat, plan):
    """b = sum_k alpha_k b_k + sum_k beta_k b''_k -> (d,) coefficients."""
    t1 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(alpha_hat, b_hat, plan), plan,
                            axis=1)
    t2 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(beta_hat, b_pp_hat, plan), plan,
                            axis=1)
    return ntt_ops.ntt_inv_modq(ntt_ops.eval_add(t1, t2, plan), plan)


# ---------------------------------------------------------------------------
# Commitments (proofgen.rs:41-153, 364-378; verification.rs:274-434)
# ---------------------------------------------------------------------------

def _tri_stream(mat_dig: torch.Tensor, params: LabradorParams) -> torch.Tensor:
    """(t, r, r, d) digits -> (n_tri, t, d) upper-triangle stream in
    (i <= j, k) order, the CRS C/D column order."""
    p = params
    rows = [mat_dig[:, i, j, :] for i in range(p.r) for j in range(i, p.r)]
    return torch.stack(rows).contiguous()


def ajtai_commit(crs, witness: torch.Tensor) -> torch.Tensor:
    """t_i = A s_i: (r_eff, n, d) residues -> (r_eff, kappa, d)."""
    return _ajtai_kernel(crs, witness.contiguous())


def u1_from_digits(crs, t_dig: torch.Tensor, g_dig: torch.Tensor,
                   params: LabradorParams) -> torch.Tensor:
    """u1 = sum_{i,k} B_ik t_i^(k) + sum_{i<=j,k} C_ijk g_ij^(k) -> (kappa_1, d)."""
    p = params
    bterm = u1_bterm(crs, t_dig.contiguous())
    cterm = cd_sum(crs, _tri_stream(g_dig, p), crs._off_c, p.t_2)
    return zq.add(bterm, cterm, p.q)


def u2_from_digits(crs, h_dig: torch.Tensor,
                   params: LabradorParams) -> torch.Tensor:
    """u2 = sum_{i<=j, k<t_1} D_ijk h_ij^(k) -> (kappa_2, d)."""
    p = params
    return cd_sum(crs, _tri_stream(h_dig, p), crs._off_d, p.t_1)


# ---------------------------------------------------------------------------
# Decompositions
# ---------------------------------------------------------------------------

def _decompose_protocol(x: torch.Tensor, base: int, ndig: int, q: int,
                        mode: str) -> torch.Tensor:
    """Digits stored as residues mod q; 'exact' decomposes the centred
    representative."""
    if zq.is_big(q):
        raise NotImplementedError("big-q digits belong to the big-q slice")
    if mode == "exact":
        x = zq.to_signed_small(x, q)
    return mod_pos(decompose(x, base, ndig, mode), q)


def decompose_t(t, params: LabradorParams, mode: str):
    """(r, kappa, d) -> (t_1, r, kappa, d)."""
    return _decompose_protocol(t, params.b_1, params.t_1, params.q, mode)


def decompose_g(g, params: LabradorParams, mode: str):
    return _decompose_protocol(g, params.b_2, params.t_2, params.q, mode)


def decompose_h(h, params: LabradorParams, mode: str):
    return _decompose_protocol(h, params.b_1, params.t_1, params.q, mode)


def decompose_z(z, params: LabradorParams, mode: str, ndig: int = 0):
    """z = z^(0) + z^(1) b: 2 digits in reference mode, ceil_log_b(q) in
    exact mode."""
    if ndig == 0:
        ndig = 2 if mode == "reference" else _ceil_log(params.q, params.b)
    return _decompose_protocol(z, params.b, ndig, params.q, mode)

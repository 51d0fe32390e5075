"""Shared prover/verifier protocol math, at big q.

The aggregations are eval-domain tensor algebra over the CRT plan
(``ntt``); the three CRS-consuming commitments are ``commit``'s plain
contractions.  Residues are int64 and ``modmath.mulmod`` takes each
product of two residues exactly.  Digits and challenges are signed.
"""

from __future__ import annotations

import torch

from . import commit, modmath, rq, zq
from . import ntt as ntt_ops
from .modmath import matmul_mod, mod_pos
from .params import LabradorParams, _ceil_log


# ---------------------------------------------------------------------------
# First aggregation (proofgen.rs:189-289 / verification.rs:38-89)
# ---------------------------------------------------------------------------

def aggregate_a_pp(a_prime: torch.Tensor, psi: torch.Tensor,
                   q: int) -> torch.Tensor:
    """a''_k = sum_l psi_k[l] a'_l: (L, r, r, d), (ub, L) -> (ub, r, r, d)."""
    terms = modmath.mulmod(a_prime[None], psi[:, :, None, None, None], q)
    return mod_pos(torch.sum(terms, dim=1), q)


# Ring elements of the JL rows per float64 product of the phi''
# aggregation: the float64 copy of one slice of pi takes 256 * d * 8 bytes
# per element (512 elements: 64 MiB); pi itself stays int8.
JL_AGG_ELEMS = 512


def aggregate_phi_pp(phi_prime: torch.Tensor, psi: torch.Tensor,
                     omega: torch.Tensor, pi: torch.Tensor,
                     params: LabradorParams) -> torch.Tensor:
    """phi''_k,i = sum_l psi_k[l] phi'_l,i + sum_j omega_k[j]
    sigma^-1(pi_i^(j)) -> (ub, r, n, d), with pi the (r, 256, n*d) int8
    JL matrices.  sigma^-1 of a ternary row stays signed ternary, so each
    slice of JL_AGG_ELEMS ring elements is conjugated and contracted with
    omega on its own: |sum| <= 256 * q < 2^53, exact in float64; only the
    result is reduced mod q (the same residues as conjugating mod q)."""
    p = params
    ub = omega.shape[0]
    lhs = mod_pos(torch.sum(
        modmath.mulmod(phi_prime[None], psi[:, :, None, None, None], p.q),
        dim=1), p.q)
    rhs = torch.empty((ub, p.r, p.n, p.d), dtype=torch.int64,
                      device=omega.device)
    for i in range(p.r):
        for e0 in range(0, p.n, JL_AGG_ELEMS):
            e1 = min(p.n, e0 + JL_AGG_ELEMS)
            rows = pi[i, :, e0 * p.d:e1 * p.d].reshape(256, e1 - e0, p.d)
            sig = rq.sigma_inv(rows.to(torch.int64), None)
            rhs[:, i, e0:e1] = matmul_mod(
                omega, sig.reshape(256, -1), p.q, p.q - 1, 1).reshape(
                    ub, e1 - e0, p.d)
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
    prod = mod_pos(torch.sum(modmath.mulmod(omega, projection[None], q), dim=1), q)
    s = mod_pos(torch.sum(modmath.mulmod(psi, b_prime[None], q), dim=1), q)
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


def canonical_aggregates(params: LabradorParams, state, proof):
    """Verifier lines 3-7 (verification.rs:38-148): the canonical a_ij
    (r, r, d), phi_i (r, n, d) and b (d,) of the aggregated relation, from
    the transcript and a dense ``structs.State``.  Each level is reduced
    mod q before the next multiplication (the CRT-range invariant)."""
    p = params
    plan = ntt_ops.plan_for(p)
    a_pp = aggregate_a_pp(state.a_prime_k[:p.l_count], proof.psi, p.q)
    phi_pp = aggregate_phi_pp(state.phi_prime_k[:p.l_count], proof.psi,
                              proof.omega, proof.pi, p)
    alpha_hat = ntt_ops.ntt_fwd(proof.alpha, plan)
    beta_hat = ntt_ops.ntt_fwd(proof.beta, plan)
    a_pp_hat = ntt_ops.ntt_fwd(a_pp, plan)
    phi_pp_hat = ntt_ops.ntt_fwd(phi_pp, plan)
    a_fin = ntt_ops.ntt_inv_modq(a_final_hat(
        alpha_hat, beta_hat, ntt_ops.ntt_fwd(state.a_k, plan), a_pp_hat,
        plan), plan)
    phi_fin = ntt_ops.ntt_inv_modq(phi_final_hat(
        alpha_hat, beta_hat, ntt_ops.ntt_fwd(state.phi_k, plan),
        phi_pp_hat, plan), plan)
    b = b_final(alpha_hat, beta_hat, ntt_ops.ntt_fwd(state.b_k, plan),
                ntt_ops.ntt_fwd(proof.b_prime_prime, plan), plan)
    return a_fin, phi_fin, b


# ---------------------------------------------------------------------------
# Commitments (proofgen.rs:41-153, 364-378; verification.rs:274-434)
# ---------------------------------------------------------------------------

def _tri_stream(mat_dig: torch.Tensor, params: LabradorParams) -> torch.Tensor:
    """(t, r, r, d) digits -> (n_tri, t, d) upper-triangle stream in
    (i <= j, k) order, the CRS C/D column order."""
    p = params
    rows = [mat_dig[..., i, j, :] for i in range(p.r) for j in range(i, p.r)]
    return torch.stack(rows, dim=-3).contiguous()


def ajtai_commit(crs, witness: torch.Tensor) -> torch.Tensor:
    """t_i = A s_i: (r_eff, n, d) -> (r_eff, kappa, d)."""
    return commit.ajtai_commit(crs, witness.contiguous())


def u1_from_digits(crs, t_dig: torch.Tensor, g_dig: torch.Tensor,
                   params: LabradorParams) -> torch.Tensor:
    """u1 = sum_{i,k} B_ik t_i^(k) + sum_{i<=j,k} C_ijk g_ij^(k):
    (kappa_1, d)."""
    p = params
    bterm = commit.u1_bterm(crs, t_dig.contiguous())
    cterm = commit.cd_sum(crs, _tri_stream(g_dig, p), crs._off_c, p.t_2)
    return zq.add(bterm, cterm, p.q)


def u2_from_digits(crs, h_dig: torch.Tensor,
                   params: LabradorParams) -> torch.Tensor:
    """u2 = sum_{i<=j, k<t_1} D_ijk h_ij^(k) -> (kappa_2, d)."""
    p = params
    return commit.cd_sum(crs, _tri_stream(h_dig, p), crs._off_d, p.t_1)


# ---------------------------------------------------------------------------
# Decompositions: exact balanced digits, kept signed
# ---------------------------------------------------------------------------

def _decompose(x: torch.Tensor, base: int, ndig: int, q: int) -> torch.Tensor:
    if not zq.is_big(q):
        raise ValueError(f"the reference runs at big q only, not q = {q}")
    return zq.decompose_balanced_big(x, base, ndig, q)


def decompose_t(t, params: LabradorParams):
    """(r, kappa, d) -> (t_1, r, kappa, d)."""
    return _decompose(t, params.b_1, params.t_1, params.q)


def decompose_g(g, params: LabradorParams):
    return _decompose(g, params.b_2, params.t_2, params.q)


def decompose_h(h, params: LabradorParams):
    return _decompose(h, params.b_1, params.t_1, params.q)


def decompose_z(z, params: LabradorParams):
    """z in ceil_log_b(q) exact digits."""
    return _decompose(z, params.b, _ceil_log(params.q, params.b), params.q)

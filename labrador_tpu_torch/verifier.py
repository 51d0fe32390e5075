"""The LaBRADOR verifier: checks 8-20 and the b'' constant term.

Counterpart of ``labrador_tpu/verifier.py`` (``check14_norm_bound``,
``verify_report``, ``verify``), with the same report keys.  Checks 15, 19
and 20 re-expand the CRS through the commitment kernels (CUDA tensors) or
their plain versions (CPU tensors).
"""

from __future__ import annotations

import math

import torch

from . import protocol
from .ops import ntt as ntt_ops
from .ops import zq
from .ops.modmath import mod_pos, sum_sq_u64, u64_sum
from .params import LabradorParams
from .structs import State, Transcript


def check14_norm_bound(p: LabradorParams, z, z_dig, t_dig, g_dig, h_dig,
                       norm_mode: str = "exact") -> bool:
    """Check 14 (verification.rs:231-267): the centred digits' squared norm
    <= beta'^2, and in exact-digit mode also ||z||^2 <= 2 gamma.

    norm_mode='exact' sums exactly (Python-int result of int64 half sums);
    'f64_reference' reproduces the reference's float accumulation in float32
    as the JAX package does (per-polynomial sums, then their sum) — exact,
    and so equal to the JAX result, while the totals stay below 2**24."""
    digs = [zq.to_signed_small(x, p.q) for x in (z_dig, t_dig, g_dig, h_dig)]
    if norm_mode == "exact":
        total = sum(u64_sum(x * x) for x in digs) % (1 << 64)
        ok = total <= int(p.beta_prime)
        if p.exact_digits:
            z_c = zq.to_signed_small(z, p.q)
            gamma_z = 2 * int(p.gamma)
            entry_max = min(math.isqrt(gamma_z), 2**31 - 1)
            ok = ok and bool(torch.all(torch.abs(z_c) <= entry_max)) \
                and sum_sq_u64(z_c) <= gamma_z
        return ok
    if norm_mode == "f64_reference":
        total = torch.zeros((), dtype=torch.float32, device=z.device)
        for x in digs:
            total = total + torch.sum(torch.sum((x * x).to(torch.float32),
                                                dim=-1))
        return bool(total <= torch.tensor(p.beta_prime, dtype=torch.float32))
    raise ValueError(f"unknown norm_mode {norm_mode!r}")


def verify_report(params: LabradorParams, state: State, proof: Transcript,
                  crs, decomp_mode: str = "reference",
                  norm_mode: str = "exact") -> dict:
    """All checks as {name: bool}, plus 'all' (checks 8-20) and
    'all_with_bpp' (also the b'' constant term)."""
    p = params
    if zq.is_big(p.q):
        raise NotImplementedError("big q belongs to the big-q slice")
    plan = ntt_ops.plan_for(p)
    checks: dict[str, bool] = {}

    # ---- lines 3-7: recomputation (verification.rs:38-148)
    a_pp = protocol.aggregate_a_pp(state.a_prime_k[:p.l_count], proof.psi,
                                   p.q)
    pi_sigma = protocol.sigma_inv_pi(proof.pi, p)
    phi_pp = protocol.aggregate_phi_pp(state.phi_prime_k[:p.l_count],
                                       proof.psi, proof.omega, pi_sigma, p)
    alpha_hat = ntt_ops.ntt_fwd(proof.alpha, plan)
    beta_hat = ntt_ops.ntt_fwd(proof.beta, plan)
    a_pp_hat = ntt_ops.ntt_fwd(a_pp, plan)
    phi_pp_hat = ntt_ops.ntt_fwd(phi_pp, plan)
    b_hat = ntt_ops.ntt_fwd(state.b_k, plan)
    b_pp_hat = ntt_ops.ntt_fwd(proof.b_prime_prime, plan)
    a_hat = ntt_ops.ntt_fwd(state.a_k, plan)
    phi_hat = ntt_ops.ntt_fwd(state.phi_k, plan)
    # reduce mod q between multiplication levels (CRT-range invariant)
    a_fin = ntt_ops.ntt_inv_modq(
        protocol.a_final_hat(alpha_hat, beta_hat, a_hat, a_pp_hat, plan),
        plan)
    phi_fin = ntt_ops.ntt_inv_modq(
        protocol.phi_final_hat(alpha_hat, beta_hat, phi_hat, phi_pp_hat,
                               plan), plan)
    a_fin_hat = ntt_ops.ntt_fwd(a_fin, plan)
    phi_fin_hat = ntt_ops.ntt_fwd(phi_fin, plan)
    b = protocol.b_final(alpha_hat, beta_hat, b_hat, b_pp_hat, plan)

    # ---- checks 8-9: symmetry (verification.rs:157-178)
    checks["c08_g_symmetric"] = zq.all_eq(proof.g, torch.swapaxes(proof.g, 0, 1))
    checks["c09_h_symmetric"] = zq.all_eq(proof.h, torch.swapaxes(proof.h, 0, 1))

    # ---- lines 10-13: decompositions (verification.rs:185-225)
    z_dig = protocol.decompose_z(proof.z, p, decomp_mode)
    t_dig = protocol.decompose_t(proof.t, p, decomp_mode)
    g_dig = protocol.decompose_g(proof.g, p, decomp_mode)
    h_dig = protocol.decompose_h(proof.h, p, decomp_mode)

    # ---- check 14: digit norm bound (verification.rs:231-267)
    checks["c14_norm_bound"] = check14_norm_bound(
        p, proof.z, z_dig, t_dig, g_dig, h_dig, norm_mode)

    # ---- check 15: A z == sum_i c_i t_i (verification.rs:274-296)
    z_hat = ntt_ops.ntt_fwd(proof.z, plan)
    lhs = protocol.ajtai_commit(crs, mod_pos(proof.z, p.q)[None])[0]
    c_hat = ntt_ops.ntt_fwd(proof.c, plan)
    t_hat = ntt_ops.ntt_fwd(proof.t, plan)
    rhs = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(c_hat[:, :, None, :], t_hat, plan), plan, axis=1),
        plan)
    checks["c15_az_vs_ct"] = zq.all_eq(lhs, rhs)

    # ---- check 16: <z,z> == sum_ij g_ij c_i c_j (verification.rs:303-314)
    P = plan.n_primes
    zz = ntt_ops.polyvec_inner_product(proof.z, proof.z, plan)
    g_hat = ntt_ops.ntt_fwd(proof.g, plan)
    cc = ntt_ops.ntt_inv_modq(
        ntt_ops.eval_mul(c_hat[:, :, None, :], c_hat[:, None, :, :], plan),
        plan)
    cc_hat = ntt_ops.ntt_fwd(cc, plan)
    rhs16 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(g_hat, cc_hat, plan).reshape(P, -1, p.d), plan,
        axis=1), plan)
    checks["c16_zz_vs_gcc"] = zq.all_eq(zz, rhs16)

    # ---- check 17: sum_i <phi_i,z> c_i == sum_ij h_ij c_i c_j
    h_hat = ntt_ops.ntt_fwd(proof.h, plan)
    piz = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(phi_fin_hat, z_hat[:, None, :, :], plan), plan,
        axis=2), plan)
    piz_hat = ntt_ops.ntt_fwd(piz, plan)
    lhs17 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(piz_hat, c_hat, plan), plan, axis=1), plan)
    rhs17 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(h_hat, cc_hat, plan).reshape(P, -1, p.d), plan,
        axis=1), plan)
    checks["c17_phiz_vs_hcc"] = zq.all_eq(lhs17, rhs17)

    # ---- check 18: sum_ij a_ij g_ij + sum_i h_ii == b (verification.rs:340-352)
    s1 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(a_fin_hat, g_hat, plan).reshape(P, -1, p.d), plan,
        axis=1), plan)
    s2 = mod_pos(torch.sum(torch.remainder(
        torch.diagonal(proof.h, dim1=0, dim2=1).T, p.q), dim=0), p.q)
    checks["c18_agg_relation"] = bool(torch.all(mod_pos(s1 + s2 - b, p.q)
                                                == 0))

    # ---- check 19: recompute u1 (verification.rs:357-415)
    u1_cand = protocol.u1_from_digits(crs, t_dig, g_dig, p)
    checks["c19_u1"] = zq.all_eq(u1_cand, proof.u_1)

    # ---- check 20: recompute u2 (verification.rs:421-434)
    u2_cand = protocol.u2_from_digits(crs, h_dig, p)
    checks["c20_u2"] = zq.all_eq(u2_cand, proof.u_2)

    # ---- b'' constant-term consistency (verification.rs:532-551)
    expected = protocol.b_pp_expected_const(
        proof.omega, proof.psi, proof.projection,
        state.b_prime_k[:p.l_count], p.q)
    checks["c21_b_pp_const"] = zq.all_eq(proof.b_prime_prime[:, 0], expected)

    checks["all"] = all(v for k, v in checks.items()
                        if not k.startswith("c21"))
    checks["all_with_bpp"] = checks["all"] and checks["c21_b_pp_const"]
    return checks


def verify(params: LabradorParams, state: State, proof: Transcript, crs,
           **kw) -> bool:
    """Verdict over the reference's 14-check predicate."""
    return verify_report(params, state, proof, crs, **kw)["all"]

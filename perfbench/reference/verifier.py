"""The LaBRADOR verifier at big q: checks 8-20, the b'' constant term, and
the Fiat-Shamir challenges, with the same report keys as the program's.
Checks 15, 19 and 20 re-expand the CRS through ``commit``'s plain
contractions.
"""

from __future__ import annotations

import math

import torch

from . import protocol, sampling, zq
from . import ntt as ntt_ops
from .keys import fold_in
from .modmath import mod_pos, sum_sq_u64, to_signed_i32, u64_sum
from .oracle import DOM_BPP, DOM_JL, DOM_U1, DOM_U2, FiatShamirOracle
from .params import LabradorParams
from .prover import (JL_MAX_ATTEMPTS, TAG_ALPHA, TAG_BETA, TAG_CHALLENGE,
                     TAG_JL, TAG_OMEGA, TAG_PSI, sample_jl)
from .structs import State, Transcript


def check14_norm_bound(p: LabradorParams, z, z_dig, t_dig, g_dig,
                       h_dig) -> bool:
    """Check 14 (verification.rs:231-267): the centred digits' squared norm
    <= beta'^2 (an exact sum, mod 2^64 as the JAX contract), and with
    exact digits also ||z||^2 <= 2 gamma."""
    digs = [zq.to_signed_small(x, p.q) for x in (z_dig, t_dig, g_dig, h_dig)]
    total = sum(u64_sum(x * x) for x in digs) % (1 << 64)
    ok = total <= int(p.beta_prime)
    if p.exact_digits:
        # the int32 word of the centred value (a wrap only for |z| >= 2^31)
        z_c = to_signed_i32(zq.to_signed_small(z, p.q))
        gamma_z = 2 * int(p.gamma)
        entry_max = min(math.isqrt(gamma_z), 2**31 - 1)
        ok = ok and bool(torch.all(torch.abs(z_c) <= entry_max)) \
            and sum_sq_u64(z_c) <= gamma_z
    return ok


def _local_checks(p: LabradorParams, state: State,
                  proof: Transcript) -> tuple[dict, dict]:
    """Every check of one proof that needs no CRS, and the operands of the
    three that re-expand it (15, 19, 20): the centred z, the right side
    of check 15, and the t, g and h digits."""
    plan = ntt_ops.plan_for(p)
    checks: dict[str, bool] = {}

    # ---- lines 3-7: recomputation (verification.rs:38-148)
    a_fin, phi_fin, b = protocol.canonical_aggregates(p, state, proof)
    a_fin_hat = ntt_ops.ntt_fwd(a_fin, plan)
    phi_fin_hat = ntt_ops.ntt_fwd(phi_fin, plan)

    # ---- checks 8-9: symmetry (verification.rs:157-178)
    checks["c08_g_symmetric"] = zq.all_eq(proof.g,
                                          torch.swapaxes(proof.g, 0, 1))
    checks["c09_h_symmetric"] = zq.all_eq(proof.h,
                                          torch.swapaxes(proof.h, 0, 1))

    # ---- lines 10-13: decompositions (verification.rs:185-225)
    z_dig = protocol.decompose_z(proof.z, p)
    t_dig = protocol.decompose_t(proof.t, p)
    g_dig = protocol.decompose_g(proof.g, p)
    h_dig = protocol.decompose_h(proof.h, p)

    # ---- check 14: digit norm bound (verification.rs:231-267)
    checks["c14_norm_bound"] = check14_norm_bound(
        p, proof.z, z_dig, t_dig, g_dig, h_dig)

    # ---- check 15's right side, sum_i c_i t_i (verification.rs:274-296);
    # z enters the kernel centred and wrapped to int32, the JAX package's
    # to_signed_small at big q (the identity on every valid z)
    z_c = to_signed_i32(zq.to_signed_small(mod_pos(proof.z, p.q), p.q))
    c_hat = ntt_ops.ntt_fwd(proof.c, plan)
    t_hat = ntt_ops.ntt_fwd(proof.t, plan)
    rhs15 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(c_hat[:, :, None, :], t_hat, plan), plan,
        axis=1), plan)

    # ---- check 16: <z,z> == sum_ij g_ij c_i c_j (verification.rs:303-314)
    P = plan.n_primes
    zz = ntt_ops.polyvec_inner_product(proof.z, proof.z, plan)
    g_hat = ntt_ops.ntt_fwd(proof.g, plan)
    cc = ntt_ops.ntt_inv_modq(
        ntt_ops.eval_mul(c_hat[:, :, None, :], c_hat[:, None, :, :],
                         plan), plan)
    cc_hat = ntt_ops.ntt_fwd(cc, plan)
    rhs16 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(g_hat, cc_hat, plan).reshape(P, -1, p.d), plan,
        axis=1), plan)
    checks["c16_zz_vs_gcc"] = zq.all_eq(zz, rhs16)

    # ---- check 17: sum_i <phi_i,z> c_i == sum_ij h_ij c_i c_j
    z_hat = ntt_ops.ntt_fwd(proof.z, plan)
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
        ntt_ops.eval_mul(a_fin_hat, g_hat, plan).reshape(P, -1, p.d),
        plan, axis=1), plan)
    s2 = mod_pos(torch.sum(torch.remainder(
        torch.diagonal(proof.h, dim1=0, dim2=1).T, p.q), dim=0), p.q)
    checks["c18_agg_relation"] = bool(torch.all(
        mod_pos(s1 + s2 - b, p.q) == 0))

    # ---- b'' constant-term consistency (verification.rs:532-551)
    expected = protocol.b_pp_expected_const(
        proof.omega, proof.psi, proof.projection,
        state.b_prime_k[:p.l_count], p.q)
    checks["c21_b_pp_const"] = zq.all_eq(proof.b_prime_prime[:, 0],
                                         expected)
    return checks, dict(z_c=z_c, rhs15=rhs15, t_dig=t_dig, g_dig=g_dig,
                        h_dig=h_dig)


def _report(checks: dict, rhs15: torch.Tensor, lhs15: torch.Tensor,
            u1_cand: torch.Tensor, u2_cand: torch.Tensor,
            proof: Transcript) -> dict:
    """The report of one proof, in the reference's check order, from its
    local checks and the CRS side of checks 15, 19 (verification.rs:357-415)
    and 20 (verification.rs:421-434)."""
    crs_side = {"c15_az_vs_ct": zq.all_eq(lhs15, rhs15),
                "c19_u1": zq.all_eq(u1_cand, proof.u_1),
                "c20_u2": zq.all_eq(u2_cand, proof.u_2)}
    order = ("c08_g_symmetric", "c09_h_symmetric", "c14_norm_bound",
             "c15_az_vs_ct", "c16_zz_vs_gcc", "c17_phiz_vs_hcc",
             "c18_agg_relation", "c19_u1", "c20_u2", "c21_b_pp_const")
    out = {k: checks[k] if k in checks else crs_side[k] for k in order}
    out["all"] = all(v for k, v in out.items() if not k.startswith("c21"))
    out["all_with_bpp"] = out["all"] and out["c21_b_pp_const"]
    return out


def verify_report(params: LabradorParams, state: State, proof: Transcript,
                  crs) -> dict:
    """All checks as {name: bool}, plus 'all' (checks 8-20) and
    'all_with_bpp' (also the b'' constant term)."""
    p = params
    checks, ops = _local_checks(p, state, proof)
    lhs15 = protocol.ajtai_commit(crs, ops["z_c"][None])[0]
    u1_cand = protocol.u1_from_digits(crs, ops["t_dig"], ops["g_dig"], p)
    u2_cand = protocol.u2_from_digits(crs, ops["h_dig"], p)
    return _report(checks, ops["rhs15"], lhs15, u1_cand, u2_cand, proof)


def _abs_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 ``abs`` of int32-range values: -2^31 stays -2^31."""
    return torch.where(x == -(1 << 31), x, torch.abs(x))


def fs_challenge_report(params: LabradorParams, state: State,
                        proof: Transcript, crs) -> dict:
    """Every challenge of the proof re-derived from the SHA-256 transcript
    hash (seeded with the CRS key, the parameters and the statement,
    FS_SPEC.md §2) and compared with the proof's, as {name: bool} with
    'fs_all'; also the JL projection's norm bound ('fs_jl_norm')."""
    p = params
    dev = proof.z.device
    oracle = FiatShamirOracle.create(crs.key, state, p)
    checks: dict[str, bool] = {}

    ost = oracle.absorb(oracle.init(), DOM_U1, [proof.u_1])
    # the JL matrices: one of the prover's bounded retry attempts (the
    # first match decides; a forged pi costs all of them)
    jl_base = oracle.challenge_key(ost, TAG_JL)
    checks["fs_jl_matrix"] = any(
        torch.equal(sample_jl(fold_in(jl_base, a), p, dev), proof.pi)
        for a in range(JL_MAX_ATTEMPTS))

    # the projection's norm bound (verification.rs:568-579) on the centred
    # int32 word of each entry, as the JAX package: every entry within
    # sqrt(128)*beta first, so the 256-term sum of squares cannot wrap
    # 2^64 and land under the bound
    centered = to_signed_i32(zq.to_signed_small(proof.projection, p.q))
    bound = 128 * p.beta_bound * p.beta_bound
    entry_max = min(math.isqrt(bound), 2**31 - 1)
    checks["fs_jl_norm"] = bool(torch.all(_abs_i32(centered) <= entry_max)) \
        and sum_sq_u64(centered) <= bound

    ost = oracle.absorb(ost, DOM_JL, [proof.pi, proof.projection])
    ub = p.upper_bound
    psi = torch.stack([sampling.sample_psi(
        oracle.challenge_key(ost, TAG_PSI, i), p, dev) for i in range(ub)])
    omega = torch.stack([sampling.sample_omega(
        oracle.challenge_key(ost, TAG_OMEGA, i), p, dev) for i in range(ub)])
    checks["fs_psi"] = zq.all_eq(psi, proof.psi)
    checks["fs_omega"] = zq.all_eq(omega, proof.omega)

    ost = oracle.absorb(ost, DOM_BPP, [proof.b_prime_prime])
    alpha = sampling.sample_alpha(oracle.challenge_key(ost, TAG_ALPHA), p,
                                  dev)
    beta = sampling.sample_beta(oracle.challenge_key(ost, TAG_BETA), p, dev)
    checks["fs_alpha"] = zq.all_eq(alpha, proof.alpha)
    checks["fs_beta"] = zq.all_eq(beta, proof.beta)

    ost = oracle.absorb(ost, DOM_U2, [proof.u_2])
    c = sampling.sample_challenges(
        [oracle.challenge_key(ost, TAG_CHALLENGE, i) for i in range(p.r)],
        p, dev)
    checks["fs_challenge"] = zq.all_eq(c, proof.c)

    checks["fs_all"] = all(checks.values())
    return checks


def verify_fs(params: LabradorParams, state: State, proof: Transcript,
              crs) -> bool:
    """Non-interactive verdict: checks 8-20, the b'' constant term and the
    Fiat-Shamir challenges."""
    return verify_report(params, state, proof, crs)["all_with_bpp"] \
        and fs_challenge_report(params, state, proof, crs)["fs_all"]

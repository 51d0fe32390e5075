"""The LaBRADOR prover, interactive and Fiat-Shamir, at big q.

Phases 1 -> 2a -> 2b -> 3 as plain functions; rejection and retry loops
are bounded Python loops.  Every tensor lives on the witness's device.
"""

from __future__ import annotations

import math

import torch

from . import modmath, protocol, sampling, zq
from . import ntt as ntt_ops
from .keys import Key, fold_in, split
from .modmath import mod_pos, sum_sq_u64, to_signed_i32
from .oracle import (DOM_BPP, DOM_JL, DOM_U1, DOM_U2, FiatShamirOracle,
                     InteractiveOracle)
from .params import LabradorParams
from .structs import State, Transcript, gram_hat

# Verifier-randomness derivation tags (protocol message order)
TAG_JL = 0
TAG_PSI = 1
TAG_OMEGA = 2
TAG_ALPHA = 3
TAG_BETA = 4
TAG_CHALLENGE = 5

JL_MAX_ATTEMPTS = 6


# Witness columns per float64 product of the JL projection.  A partial
# sum of one chunk is at most JL_CHUNK * 128 in magnitude, exact in
# float64, and the float64 copy of one chunk of a JL matrix takes
# 256 * JL_CHUNK * 8 bytes (128 MiB); the matrix itself stays int8.
JL_CHUNK = 1 << 16
JL_LIMBS = 4


# random words drawn per batch of JL matrices (the int64 words take 32 MiB)
JL_GROUP_WORDS = 1 << 22


def sample_jl(key, params: LabradorParams, device="cuda"):
    """The JL matrices of one attempt: (r, 256, n*d) int8, one ternary
    matrix per witness vector from split(key, r), drawn a group of keys
    at a time."""
    p = params
    ks = split(key, p.r)
    group = max(1, JL_GROUP_WORDS // (256 * p.n * p.d))
    pi = torch.empty((p.r, 256, p.n * p.d), dtype=torch.int8, device=device)
    for i in range(0, p.r, group):
        pi[i:i + group] = sampling.sample_jl_matrices(ks[i:i + group], p,
                                                      device)
    return pi


def jl_limb_dots(pi: torch.Tensor, w_c: torch.Tensor) -> torch.Tensor:
    """The JAX package's four int8 limb dots of the JL projection.

    pi (r, R, m) int8 ternary, w_c (r, m) signed witness in the int32 range
    (any integers: only their value mod 2^32 counts).  Each limb
    ``((v + 128) & 255) - 128`` of v, then ``v = (v - limb) >> 8``, is
    contracted with pi over all r*m columns; the JAX package accumulates
    that dot in int32, whose wrapped sum is the exact sum mod 2^32 in any
    order.  Here each JL_CHUNK-column slice of pi is widened to float64 on
    its own, its exact partial sums are added in int64 with no device
    sync, and the totals are wrapped to int32 at the end.  Returns (R, 4)
    int64 in the int32 range, limb k in column k."""
    r, rows, m = pi.shape
    v = to_signed_i32(w_c.to(torch.int64))
    limbs = []
    for _ in range(JL_LIMBS):
        limb = ((v + 128) & 255) - 128
        limbs.append(limb)
        v = (v - limb) >> 8
    limbs = torch.stack(limbs, dim=-1).to(torch.int8)         # (r, m, 4)
    acc = torch.zeros((rows, JL_LIMBS), dtype=torch.int64, device=pi.device)
    for i in range(r):
        for c0 in range(0, m, JL_CHUNK):
            c1 = min(m, c0 + JL_CHUNK)
            part = pi[i, :, c0:c1].to(torch.float64) \
                @ limbs[i, c0:c1].to(torch.float64)
            acc += part.to(torch.int64)
    return to_signed_i32(acc)


def jl_recombine(dots: torch.Tensor):
    """The JAX package's emulated i64 ``((d3*256 + d2)*256 + d1)*256 + d0``
    of the (R, 4) limb dots (exact in int64: |d3 * 2^24| < 2^55), ``fits``
    as "the high word is the sign extension of the low one", that is the
    value lies in the int32 range, and the projection as the low word.
    Returns (proj (R,) int64 in the int32 range, fits bool)."""
    acc = dots[:, 3]
    for k in (2, 1, 0):
        acc = acc * 256 + dots[:, k]
    fits = bool(torch.all((acc >= -(1 << 31)) & (acc < (1 << 31))))
    return to_signed_i32(acc), fits


def jl_projection(pi: torch.Tensor, w_c: torch.Tensor):
    """Projection of the centred witness w_c (r, m) by pi (r, 256, m) int8
    as the JAX package computes it, exact at every size: (proj (256,)
    int64 in the int32 range, fits)."""
    return jl_recombine(jl_limb_dots(pi, w_c))


def jl_project(key, witness_flat: torch.Tensor, params: LabradorParams):
    """One JL attempt: ternary Pi per witness vector and the projection of
    the centred witness.  Returns (pi (r, 256, n*d) int8, projection (256,)
    int32-range int64, ok)."""
    p = params
    pi = sample_jl(key, p, witness_flat.device)
    # centred residues, and the signed int32 witness at big q
    proj, fits = jl_projection(pi, zq.to_signed_small(witness_flat, p.q))
    # a per-entry bound keeps the 256-term sum of squares exact
    bound = 128 * p.beta_bound * p.beta_bound
    entry_max = min(math.isqrt(bound), 2**31 - 1)
    ok = fits and bool(torch.all(torch.abs(proj) <= entry_max)) \
        and sum_sq_u64(proj) <= bound
    return pi, proj, ok


def _jl_with_retries(key, witness_flat: torch.Tensor,
                     params: LabradorParams):
    """JL projection retried with fold_in(key, i) for i < 6 (the reference
    retries five times, proofgen.rs:169-181); ok False after the last."""
    for i in range(JL_MAX_ATTEMPTS):
        pi, proj, ok = jl_project(fold_in(key, i), witness_flat, params)
        if ok:
            break
    return pi, proj, ok


def _gram(witness: torch.Tensor, plan) -> torch.Tensor:
    """The Gram matrix g_ij = <s_i, s_j> (r, r, d) of one witness."""
    return ntt_ops.ntt_inv_modq(gram_hat(ntt_ops.ntt_fwd(witness, plan),
                                         plan), plan)


def prove_phase1(params: LabradorParams, witness: torch.Tensor, state: State,
                 crs, oracle, ost):
    """Steps 1-3: Ajtai t, Gram g, outer commitment u1."""
    p = params
    plan = ntt_ops.plan_for(p)
    t = protocol.ajtai_commit(crs, witness)
    g = _gram(witness, plan)
    t_dig = protocol.decompose_t(t, p)
    g_dig = protocol.decompose_g(g, p)
    u_1 = protocol.u1_from_digits(crs, t_dig, g_dig, p)
    return ost, dict(t=t, g=g, u_1=u_1)


def prove_phase2a(params: LabradorParams, witness: torch.Tensor,
                  state: State, crs, oracle, ost, ph1: dict):
    """Step 4: JL projection with retries."""
    p = params
    ost = oracle.absorb(ost, DOM_U1, [ph1["u_1"]])
    pi, proj, jl_ok = _jl_with_retries(
        oracle.challenge_key(ost, TAG_JL), witness.reshape(p.r, p.n * p.d), p)
    projection = mod_pos(proj, p.q)                   # lift (proofgen.rs:186)
    ost = oracle.absorb(ost, DOM_JL, [pi, projection])
    return ost, dict(pi=pi, projection=projection,
                     jl_ok=torch.tensor(jl_ok, device=witness.device))


def prove_phase2b(params: LabradorParams, witness: torch.Tensor,
                  state: State, crs, oracle, ost, ph1: dict, ph2a: dict):
    """Steps 5-8: both aggregations, h, u2."""
    p = params
    ost, out = _aggregate_h(p, witness, state, oracle, ost, ph1["g"], ph2a)
    h_dig = protocol.decompose_h(out["h"], p)
    return ost, {**out, "u_2": protocol.u2_from_digits(crs, h_dig, p)}


def _aggregate_h(params: LabradorParams, witness: torch.Tensor, state: State,
                 oracle, ost, g: torch.Tensor, ph2a: dict):
    """Steps 5-7 of one instance: both aggregations and h (no CRS)."""
    p = params
    dev = witness.device
    plan = ntt_ops.plan_for(p)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    pi, projection = ph2a["pi"], ph2a["projection"]

    # -- step 5: first aggregation (proofgen.rs:189-289)
    ub = p.upper_bound
    psi = torch.stack([sampling.sample_psi(
        oracle.challenge_key(ost, TAG_PSI, i), p, dev) for i in range(ub)])
    omega = torch.stack([sampling.sample_omega(
        oracle.challenge_key(ost, TAG_OMEGA, i), p, dev) for i in range(ub)])
    a_pp = protocol.aggregate_a_pp(state.a_prime_k[:p.l_count], psi, p.q)
    phi_pp = protocol.aggregate_phi_pp(state.phi_prime_k[:p.l_count], psi,
                                       omega, pi, p)
    a_pp_hat = ntt_ops.ntt_fwd(a_pp, plan)
    phi_pp_hat = ntt_ops.ntt_fwd(phi_pp, plan)
    # multiply only transforms of reduced tensors (CRT-range invariant)
    g_hat_red = ntt_ops.ntt_fwd(g, plan)
    b_pp = protocol.b_pp_from_witness(a_pp_hat, phi_pp_hat, s_hat, g_hat_red,
                                      plan)
    expected = protocol.b_pp_expected_const(
        omega, psi, projection, state.b_prime_k[:p.l_count], p.q)
    b_pp_ok = zq.all_eq(b_pp[:, 0], expected)

    # -- step 6: second aggregation (proofgen.rs:295-314)
    ost = oracle.absorb(ost, DOM_BPP, [b_pp])
    alpha = sampling.sample_alpha(oracle.challenge_key(ost, TAG_ALPHA), p,
                                  dev)
    beta = sampling.sample_beta(oracle.challenge_key(ost, TAG_BETA), p, dev)
    alpha_hat = ntt_ops.ntt_fwd(alpha, plan)
    beta_hat = ntt_ops.ntt_fwd(beta, plan)
    phi_hat = ntt_ops.ntt_fwd(state.phi_k, plan)
    phi_fin = ntt_ops.ntt_inv_modq(
        protocol.phi_final_hat(alpha_hat, beta_hat, phi_hat, phi_pp_hat,
                               plan), plan)
    phi_fin_hat_red = ntt_ops.ntt_fwd(phi_fin, plan)

    # -- step 7: h = (m + m^T) / 2 with m_ij = <phi_i, s_j> (proofgen.rs:320-358)
    m_hat = ntt_ops.eval_matmul(phi_fin_hat_red,
                                torch.swapaxes(s_hat, -3, -2), plan)
    m = ntt_ops.ntt_inv_modq(m_hat, plan)
    h = modmath.mulmod(mod_pos(m + torch.swapaxes(m, 0, 1), p.q),
                       p.inv2, p.q)
    # (step 8, the outer commitment u2 of h's digits, proofgen.rs:364-378,
    # follows in the caller: one kernel launch for one instance or a batch)
    return ost, dict(psi=psi, omega=omega, b_prime_prime=b_pp, alpha=alpha,
                     beta=beta, h=h,
                     b_pp_ok=torch.tensor(b_pp_ok, device=dev))


def prove_phase3(params: LabradorParams, witness: torch.Tensor, oracle, ost,
                 ph2: dict):
    """Step 9: amortized opening z = sum_i c_i s_i."""
    p = params
    ost = oracle.absorb(ost, DOM_U2, [ph2["u_2"]])
    c = sampling.sample_challenges(_challenge_keys(p, oracle, ost), p,
                                   witness.device)
    return dict(c=c, z=_opening(p, witness, c))


def _challenge_keys(params: LabradorParams, oracle, ost) -> list:
    return [oracle.challenge_key(ost, TAG_CHALLENGE, i)
            for i in range(params.r)]


def _opening(params: LabradorParams, witness: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """z = sum_i c_i s_i (n, d) of one instance."""
    plan = ntt_ops.plan_for(params)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    c_hat = ntt_ops.ntt_fwd(c, plan)
    prod = ntt_ops.eval_mul(c_hat[:, :, None, :], s_hat, plan)
    return ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(prod, plan, axis=1), plan)


def prove_impl(params: LabradorParams, witness: torch.Tensor, state: State,
               crs, oracle) -> Transcript:
    """Phases 1 -> 2a -> 2b -> 3 with the oracle state carried through."""
    ost = oracle.init()
    ost, ph1 = prove_phase1(params, witness, state, crs, oracle, ost)
    ost, ph2a = prove_phase2a(params, witness, state, crs, oracle, ost, ph1)
    ost, ph2b = prove_phase2b(params, witness, state, crs, oracle, ost, ph1,
                              ph2a)
    ph2 = {**ph2a, **ph2b}
    ph3 = prove_phase3(params, witness, oracle, ost, ph2)
    return Transcript(t=ph1["t"], g=ph1["g"], u_1=ph1["u_1"], **ph2, **ph3)


def prove(params: LabradorParams, witness: torch.Tensor, state: State, crs,
          verifier_key: Key) -> Transcript:
    """Interactive-model proof: challenges from the verifier's key."""
    return prove_impl(params, witness, state, crs,
                      InteractiveOracle(vkey=verifier_key))


def prove_fs(params: LabradorParams, witness: torch.Tensor, state: State,
             crs) -> Transcript:
    """Non-interactive (Fiat-Shamir) proof: challenges from a SHA-256
    running hash of the protocol messages, with the CRS seed, the
    parameter set and the statement bound into the initial state
    (FS_SPEC.md)."""
    return prove_impl(params, witness, state, crs,
                      FiatShamirOracle.create(crs.key, state, params))

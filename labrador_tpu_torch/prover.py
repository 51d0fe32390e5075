"""The LaBRADOR prover, interactive mode at small q.

Counterpart of ``labrador_tpu/prover.py`` (``prove_phase1/2a/2b/3``,
``prove_impl``, ``prove``).  PyTorch runs eagerly, so the phases are plain
functions and the JAX ``while_loop``s are bounded Python loops.  Every
tensor lives on the witness's device; on CUDA the three commitments run
the hand-written kernels, on the CPU their plain versions.
"""

from __future__ import annotations

import math

import torch

from . import protocol, sampling
from .keys import Key, fold_in, split
from .ops import ntt as ntt_ops
from .ops import zq
from .ops.modmath import matmul_exact, mod_pos, sum_sq_u64, to_signed_i32
from .oracle import DOM_BPP, DOM_JL, DOM_U1, DOM_U2, InteractiveOracle
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


def resolve_backend(device) -> str:
    """Which commitment kernels run: 'cuda' for tensors on a CUDA device,
    'plain' (the PyTorch versions) for CPU tensors."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "plain"
    raise ValueError(f"no kernels for device type {kind!r}")


def _check_slice(params: LabradorParams) -> None:
    if zq.is_big(params.q):
        raise NotImplementedError("big q belongs to the big-q slice")


def jl_project(key: Key, witness_flat: torch.Tensor, params: LabradorParams):
    """One JL attempt: ternary Pi per witness vector and the exact integer
    projection of the centred witness.  Returns (pi (r, 256, n*d) int8,
    projection (256,) int32-range int64, ok)."""
    p = params
    dev = witness_flat.device
    pi = torch.stack([sampling.sample_jl_matrix(k, p, dev)
                      for k in split(key, p.r)])
    w_c = zq.to_signed_small(witness_flat, p.q)
    pi_flat = torch.movedim(pi, 1, 0).reshape(256, -1).to(torch.int64)
    proj = matmul_exact(pi_flat, w_c.reshape(-1, 1), 1, p.q // 2)[:, 0]
    # the JAX package keeps the low int32 word and flags values that do not
    # fit; a per-entry bound keeps the 256-term sum of squares exact
    fits = bool(torch.all((proj >= -(1 << 31)) & (proj < (1 << 31))))
    proj = to_signed_i32(proj)
    bound = 128 * p.beta_bound * p.beta_bound
    entry_max = min(math.isqrt(bound), 2**31 - 1)
    ok = fits and bool(torch.all(torch.abs(proj) <= entry_max)) \
        and sum_sq_u64(proj) <= bound
    return pi, proj, ok


def _jl_with_retries(key: Key, witness_flat: torch.Tensor,
                     params: LabradorParams):
    """JL projection retried with fold_in(key, i) for i < 6 (the reference
    retries five times, proofgen.rs:169-181); ok False after the last."""
    for i in range(JL_MAX_ATTEMPTS):
        pi, proj, ok = jl_project(fold_in(key, i), witness_flat, params)
        if ok:
            break
    return pi, proj, ok


def prove_phase1(params: LabradorParams, witness: torch.Tensor, state: State,
                 crs, oracle, ost, decomp_mode: str = "reference"):
    """Steps 1-3: Ajtai t (kernel), Gram g, outer commitment u1 (kernels)."""
    p = params
    _check_slice(p)
    plan = ntt_ops.plan_for(p)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    t = protocol.ajtai_commit(crs, witness)
    g = ntt_ops.ntt_inv_modq(gram_hat(s_hat, plan), plan)
    t_dig = protocol.decompose_t(t, p, decomp_mode)
    g_dig = protocol.decompose_g(g, p, decomp_mode)
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
                  state: State, crs, oracle, ost, ph1: dict, ph2a: dict,
                  decomp_mode: str = "reference"):
    """Steps 5-8: both aggregations, h, u2 (kernel)."""
    p = params
    dev = witness.device
    plan = ntt_ops.plan_for(p)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    g = ph1["g"]
    pi, projection = ph2a["pi"], ph2a["projection"]

    # -- step 5: first aggregation (proofgen.rs:189-289)
    ub = p.upper_bound
    psi = torch.stack([sampling.sample_psi(
        oracle.challenge_key(ost, TAG_PSI, i), p, dev) for i in range(ub)])
    omega = torch.stack([sampling.sample_omega(
        oracle.challenge_key(ost, TAG_OMEGA, i), p, dev) for i in range(ub)])
    a_pp = protocol.aggregate_a_pp(state.a_prime_k[:p.l_count], psi, p.q)
    pi_sigma = protocol.sigma_inv_pi(pi, p)
    phi_pp = protocol.aggregate_phi_pp(state.phi_prime_k[:p.l_count], psi,
                                       omega, pi_sigma, p)
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
    h = mod_pos(mod_pos(m + torch.swapaxes(m, 0, 1), p.q) * p.inv2, p.q)

    # -- step 8: outer commitment u2 (proofgen.rs:364-378)
    h_dig = protocol.decompose_h(h, p, decomp_mode)
    u_2 = protocol.u2_from_digits(crs, h_dig, p)
    return ost, dict(psi=psi, omega=omega, b_prime_prime=b_pp, alpha=alpha,
                     beta=beta, u_2=u_2, h=h,
                     b_pp_ok=torch.tensor(b_pp_ok, device=dev))


def prove_phase3(params: LabradorParams, witness: torch.Tensor, oracle, ost,
                 ph2: dict):
    """Step 9: amortized opening z = sum_i c_i s_i."""
    p = params
    dev = witness.device
    plan = ntt_ops.plan_for(p)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    ost = oracle.absorb(ost, DOM_U2, [ph2["u_2"]])
    c = torch.stack([sampling.sample_challenge(
        oracle.challenge_key(ost, TAG_CHALLENGE, i), p, dev)
        for i in range(p.r)])
    c_hat = ntt_ops.ntt_fwd(c, plan)
    prod = ntt_ops.eval_mul(c_hat[:, :, None, :], s_hat, plan)
    z = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(prod, plan, axis=1), plan)
    return dict(c=c, z=z)


def prove_impl(params: LabradorParams, witness: torch.Tensor, state: State,
               crs, oracle, decomp_mode: str = "reference") -> Transcript:
    """Phases 1 -> 2a -> 2b -> 3 with the oracle state carried through."""
    ost = oracle.init()
    ost, ph1 = prove_phase1(params, witness, state, crs, oracle, ost,
                            decomp_mode)
    ost, ph2a = prove_phase2a(params, witness, state, crs, oracle, ost, ph1)
    ost, ph2b = prove_phase2b(params, witness, state, crs, oracle, ost, ph1,
                              ph2a, decomp_mode)
    ph2 = {**ph2a, **ph2b}
    ph3 = prove_phase3(params, witness, oracle, ost, ph2)
    return Transcript(t=ph1["t"], g=ph1["g"], u_1=ph1["u_1"], **ph2, **ph3)


def prove(params: LabradorParams, witness: torch.Tensor, state: State, crs,
          verifier_key: Key, decomp_mode: str = "reference") -> Transcript:
    """Interactive-model proof: challenges from the verifier's key."""
    return prove_impl(params, witness, state, crs,
                      InteractiveOracle(vkey=verifier_key), decomp_mode)

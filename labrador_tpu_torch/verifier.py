"""The LaBRADOR verifier: checks 8-20, the b'' constant term, and the
Fiat-Shamir challenges.

Counterpart of ``labrador_tpu/verifier.py`` (``check14_norm_bound``,
``verify_report``, ``verify``, ``fs_challenge_report``, ``verify_fs``),
with the same report keys, for a dense ``structs.State`` or (interactive
only) a ``recursion.FoldedState``; ``verify_recursive`` checks a
``structs.RecursiveProof`` without its base opening.  Checks 15, 19 and 20
re-expand the CRS through the commitment kernels (CUDA tensors) or their
plain versions (CPU tensors), sharded over a mesh's rows group when
``verify_report`` is given a ``protocol.AxisCtx``.  ``verify_report_batch``
verifies B independent proofs, each of those kernels launched once for
the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import protocol, recursion, sampling
from .crs import CRSBatch
from .keys import fold_in
from .ops import ntt as ntt_ops
from .ops import zq
from .ops.modmath import mod_pos, sum_sq_u64, to_signed_i32, u64_sum
from .oracle import DOM_BPP, DOM_JL, DOM_U1, DOM_U2, FiatShamirOracle
from .params import LabradorParams
from .prover import (JL_MAX_ATTEMPTS, TAG_ALPHA, TAG_BETA, TAG_CHALLENGE,
                     TAG_JL, TAG_OMEGA, TAG_PSI, sample_jl)
from .structs import RecursiveProof, State, Transcript, take
from .utils.profiling import section as _section


# XLA on the CPU splits a float32 sum over a dimension longer than 32
# (TreeReductionRewriter): each such dimension is padded with zeros to a
# multiple of 32, half of the padding in front, and cut into windows of
# 32; every dimension of 32 or fewer is one window.  Each window is summed
# in row-major order from 0, and the windows' sums are reduced the same
# way, until no dimension is longer than 32.
_XLA_WINDOW = 32


def _xla_f32_sum(x: np.ndarray, axes: tuple) -> np.ndarray:
    """float32 sum of ``x`` over ``axes`` in XLA's CPU order (above)."""
    axes = tuple(sorted(a % x.ndim for a in axes))
    if all(x.shape[a] <= _XLA_WINDOW for a in axes):
        keep = [a for a in range(x.ndim) if a not in axes]
        flat = np.transpose(x, keep + list(axes)).reshape(
            [x.shape[a] for a in keep] + [-1])
        # cumsum is a strictly sequential float32 accumulation
        return np.cumsum(flat, axis=-1, dtype=np.float32)[..., -1]
    pad, shape, win_axes, count_axes = [], [], [], []
    for a, n in enumerate(x.shape):
        w = min(_XLA_WINDOW, n) if a in axes else n
        extra = -n % w
        pad.append((extra // 2, extra - extra // 2))
        if a in axes:
            count_axes.append(len(shape) - len(win_axes))
            win_axes.append(len(shape) + 1)
            shape += [(n + extra) // w, w]
        else:
            shape.append(n)
    parts = _xla_f32_sum(np.pad(x, pad).reshape(shape), tuple(win_axes))
    return _xla_f32_sum(parts, tuple(count_axes))


def check14_norm_bound(p: LabradorParams, z, z_dig, t_dig, g_dig, h_dig,
                       norm_mode: str = "exact") -> bool:
    """Check 14 (verification.rs:231-267): the centred digits' squared norm
    <= beta'^2, and in exact-digit mode also ||z||^2 <= 2 gamma.

    norm_mode='exact' sums exactly (Python-int result of int64 half sums);
    'f64_reference' reproduces the reference's float accumulation in
    float32 as the JAX package does on the CPU: per-polynomial sums over
    the last axis, a total per digit tensor, then z + t + g + h, each in
    XLA's order.  Above 2^24 the float32 verdict near the bound depends on
    that order, so it is taken on the host in that one order whatever
    device the digits are on."""
    digs = [zq.to_signed_small(x, p.q) for x in (z_dig, t_dig, g_dig, h_dig)]
    if norm_mode == "exact":
        total = sum(u64_sum(x * x) for x in digs) % (1 << 64)
        ok = total <= int(p.beta_prime)
        if p.exact_digits:
            # the JAX package's to_signed_small keeps the int32 word of the
            # centred value (a wrap only at big q, only for |z| >= 2^31)
            z_c = to_signed_i32(zq.to_signed_small(z, p.q))
            gamma_z = 2 * int(p.gamma)
            entry_max = min(math.isqrt(gamma_z), 2**31 - 1)
            ok = ok and bool(torch.all(torch.abs(z_c) <= entry_max)) \
                and sum_sq_u64(z_c) <= gamma_z
        return ok
    if norm_mode == "f64_reference":
        total = np.float32(0)
        for x in digs:
            sq = (x * x).cpu().numpy().astype(np.float32)
            per = _xla_f32_sum(sq, (-1,))
            total = np.float32(total + _xla_f32_sum(
                per, tuple(range(per.ndim))))
        return bool(total <= np.float32(p.beta_prime))
    raise ValueError(f"unknown norm_mode {norm_mode!r}")


def b_pp_const_ok(p: LabradorParams, state, proof: Transcript) -> bool:
    """The b'' constant-term consistency (verification.rs:532-551): no
    field of the opening."""
    expected = protocol.b_pp_expected_const(
        proof.omega, proof.psi, proof.projection,
        state.b_prime_k[:p.l_count], p.q)
    return zq.all_eq(proof.b_prime_prime[:, 0], expected)


def projection_norm_ok(p: LabradorParams, projection: torch.Tensor) -> bool:
    """The projection's norm bound (verification.rs:568-579) on the
    centred int32 word of each entry, as the JAX package: every entry
    within sqrt(128)*beta first, so the 256-term sum of squares cannot
    wrap 2^64 and land under the bound."""
    centered = to_signed_i32(zq.to_signed_small(projection, p.q))
    bound = 128 * p.beta_bound * p.beta_bound
    entry_max = min(math.isqrt(bound), 2**31 - 1)
    return bool(torch.all(_abs_i32(centered) <= entry_max)) \
        and sum_sq_u64(centered) <= bound


def _local_checks(p: LabradorParams, state: State, proof: Transcript,
                  decomp_mode: str, norm_mode: str,
                  timer=None) -> tuple[dict, dict]:
    """Every check of one proof that needs no CRS, and the operands of the
    three that re-expand it (15, 19, 20): the centred z, the right side
    of check 15, and the t, g and h digits.  With ``timer`` each section
    is timed under its check's name (a tensor shared by several checks
    counts in the first)."""
    plan = ntt_ops.plan_for(p)
    checks: dict[str, bool] = {}

    # ---- lines 3-7: recomputation (verification.rs:38-148)
    with _section(timer, "aggregates"):
        a_fin, phi_fin, b = protocol.canonical_aggregates(p, state, proof,
                                                          timer)
        a_fin_hat = ntt_ops.ntt_fwd(a_fin, plan)
        phi_fin_hat = ntt_ops.ntt_fwd(phi_fin, plan)

    # ---- checks 8-9: symmetry (verification.rs:157-178)
    with _section(timer, "c08_c09_symmetric"):
        checks["c08_g_symmetric"] = zq.all_eq(proof.g,
                                              torch.swapaxes(proof.g, 0, 1))
        checks["c09_h_symmetric"] = zq.all_eq(proof.h,
                                              torch.swapaxes(proof.h, 0, 1))

    # ---- lines 10-13: decompositions (verification.rs:185-225)
    with _section(timer, "decompositions"):
        z_dig = protocol.decompose_z(proof.z, p, decomp_mode)
        t_dig = protocol.decompose_t(proof.t, p, decomp_mode)
        g_dig = protocol.decompose_g(proof.g, p, decomp_mode)
        h_dig = protocol.decompose_h(proof.h, p, decomp_mode)

    # ---- check 14: digit norm bound (verification.rs:231-267)
    with _section(timer, "c14_norm_bound"):
        checks["c14_norm_bound"] = check14_norm_bound(
            p, proof.z, z_dig, t_dig, g_dig, h_dig, norm_mode)

    # ---- check 15's right side, sum_i c_i t_i (verification.rs:274-296);
    # z enters the kernel centred and wrapped to int32, the JAX package's
    # to_signed_small at big q (the identity on every valid z)
    with _section(timer, "c15_az_vs_ct"):
        z_c = to_signed_i32(zq.to_signed_small(mod_pos(proof.z, p.q), p.q))
        c_hat = ntt_ops.ntt_fwd(proof.c, plan)
        t_hat = ntt_ops.ntt_fwd(proof.t, plan)
        rhs15 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
            ntt_ops.eval_mul(c_hat[:, :, None, :], t_hat, plan), plan,
            axis=1), plan)

    # ---- check 16: <z,z> == sum_ij g_ij c_i c_j (verification.rs:303-314)
    P = plan.n_primes
    with _section(timer, "c16_zz_vs_gcc"):
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
    with _section(timer, "c17_phiz_vs_hcc"):
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
    with _section(timer, "c18_agg_relation"):
        s1 = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
            ntt_ops.eval_mul(a_fin_hat, g_hat, plan).reshape(P, -1, p.d),
            plan, axis=1), plan)
        s2 = mod_pos(torch.sum(torch.remainder(
            torch.diagonal(proof.h, dim1=0, dim2=1).T, p.q), dim=0), p.q)
        checks["c18_agg_relation"] = bool(torch.all(
            mod_pos(s1 + s2 - b, p.q) == 0))

    # ---- b'' constant-term consistency (verification.rs:532-551)
    with _section(timer, "c21_b_pp_const"):
        checks["c21_b_pp_const"] = b_pp_const_ok(p, state, proof)
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
                  crs, decomp_mode: str = "reference",
                  norm_mode: str = "exact",
                  ctx: protocol.AxisCtx | None = None, timer=None) -> dict:
    """All checks as {name: bool}, plus 'all' (checks 8-20) and
    'all_with_bpp' (also the b'' constant term).  With ``ctx`` checks 15,
    19 and 20 run sharded over its group (``parallel/sharded.py``).  With
    ``timer`` (a ``utils.profiling.PhaseTimer``) each check's section is
    timed under its name, between device syncs; without one nothing
    syncs."""
    p = params
    checks, ops = _local_checks(p, state, proof, decomp_mode, norm_mode,
                                timer)
    with _section(timer, "c15_az_vs_ct"):
        lhs15 = protocol.ajtai_commit(crs, ops["z_c"][None], ctx)[0]
    with _section(timer, "c19_u1"):
        u1_cand = protocol.u1_from_digits(crs, ops["t_dig"], ops["g_dig"],
                                          p, ctx)
    with _section(timer, "c20_u2"):
        u2_cand = protocol.u2_from_digits(crs, ops["h_dig"], p, ctx)
    return _report(checks, ops["rhs15"], lhs15, u1_cand, u2_cand, proof)


def verify_report_batch(params: LabradorParams, state_b: State,
                        proof_b: Transcript, crs_b: CRSBatch,
                        decomp_mode: str = "reference",
                        norm_mode: str = "exact",
                        ctx: protocol.AxisCtx | None = None) -> dict:
    """``verify_report`` of B independent proofs (the JAX package's vmap
    of ``verify_report_impl``): ``state_b`` and ``proof_b`` lead with B,
    ``crs_b`` is a ``crs.CRSBatch``.  Returns {check: bool tensor (B,)} on
    the proofs' device.  The CRS re-expansions of checks 15, 19 and 20
    launch each kernel once for the batch (sharded over ``ctx``'s group
    when given); the checks that need no CRS run in a loop over the
    instances."""
    p = params
    if not isinstance(crs_b, CRSBatch):
        raise TypeError(f"batched verification takes a crs.CRSBatch of "
                        f"Threefry CRSs, not {type(crs_b).__name__}")
    B = len(crs_b)
    proofs = [take(proof_b, b) for b in range(B)]
    local = [_local_checks(p, take(state_b, b), proofs[b], decomp_mode,
                           norm_mode) for b in range(B)]

    def ops(name: str) -> torch.Tensor:
        return torch.stack([o[name] for _, o in local])

    lhs15 = protocol.ajtai_commit(crs_b, ops("z_c")[:, None], ctx)[:, 0]
    u1_cand = protocol.u1_from_digits(crs_b, ops("t_dig"), ops("g_dig"), p,
                                      ctx)
    u2_cand = protocol.u2_from_digits(crs_b, ops("h_dig"), p, ctx)
    reports = [_report(local[b][0], local[b][1]["rhs15"], lhs15[b],
                       u1_cand[b], u2_cand[b], proofs[b]) for b in range(B)]
    return {k: torch.tensor([r[k] for r in reports],
                            device=proof_b.z.device) for k in reports[0]}


def verify(params: LabradorParams, state: State, proof: Transcript, crs,
           **kw) -> bool:
    """Verdict over the reference's 14-check predicate."""
    return verify_report(params, state, proof, crs, **kw)["all"]


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

    checks["fs_jl_norm"] = projection_norm_ok(p, proof.projection)

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


def verify_fs(params: LabradorParams, state: State, proof: Transcript, crs,
              **kw) -> bool:
    """Non-interactive verdict: checks 8-20, the b'' constant term and the
    Fiat-Shamir challenges."""
    return verify_report(params, state, proof, crs, **kw)["all_with_bpp"] \
        and fs_challenge_report(params, state, proof, crs)["fs_all"]


def _transcript_shapes(p: LabradorParams) -> dict:
    """The shape of each transcript field under ``p``."""
    ub, d = p.upper_bound, p.d
    return {"u_1": (p.kappa_1, d), "pi": (p.r, 256, p.n * d),
            "projection": (256,), "psi": (ub, p.l_count),
            "omega": (ub, 256), "b_prime_prime": (ub, d),
            "alpha": (p.k_count, d), "beta": (ub, d), "u_2": (p.kappa_2, d),
            "c": (p.r, d), "z": (p.n, d), "t": (p.r, p.kappa, d),
            "g": (p.r, p.r, d), "h": (p.r, p.r, d)}


def _shapes_ok(p: LabradorParams, proof: Transcript, skip=()) -> bool:
    return all(tuple(getattr(proof, k).shape) == v
               for k, v in _transcript_shapes(p).items() if k not in skip)


def verify_recursive(params: LabradorParams, state, rproof: RecursiveProof,
                     crs, mu: int = 16, kappa_new: int = 16,
                     timer=None) -> dict:
    """Check a recursive proof (``prover.prove_recursive``) against the
    base statement (``params``, ``state``, ``crs``) without the base
    opening, as {name: bool} with 'all' over four checks:

    * ``base_public``: the base verifier's checks that read no field of
      the opening z, t, g, h: the base transcript's shapes
      (``base.shapes``), the b'' constant term (``base.c21_b_pp_const``,
      check 21) and the projection's norm bound (``base.jl_norm``,
      verification.rs:568-579, as ``fs_challenge_report``'s
      ``fs_jl_norm``).  Checks 8-20 each read the opening; the folded
      relation carries 15 and 18-20 and 16-17's algebra, not check 14's
      ||z||^2 <= 2 gamma (the JAX package's design);
    * ``beta_new_bound``: 1 <= beta' <= ``recursion.beta_new_max``;
    * ``fold_statement``: the folded statement rebuilt from the public
      fields (``recursion.fold_statement``), and the folded transcript's
      shapes under its params;
    * ``folded``: the folded transcript's ``verify_report``
      ('all_with_bpp', each check also as ``folded.<check>``) on
      ``recursion.folded_crs``.

    A check after a failed ``beta_new_bound`` or ``fold_statement`` is not
    run and reads False.  With ``timer`` (a ``utils.profiling.PhaseTimer``)
    the sections ``base_public``, ``fold_statement`` and
    ``folded_verify`` are timed between device syncs, and inside the last
    the folded ``verify_report``'s own sections (its aggregates'
    ``alpha_contract``, the checks'); without one nothing syncs."""
    p = params
    base = rproof.base
    out: dict[str, bool] = {}
    with _section(timer, "base_public"):
        out["base.shapes"] = _shapes_ok(p, base, skip=("z", "t", "g", "h"))
        out["base.c21_b_pp_const"] = out["base.shapes"] \
            and b_pp_const_ok(p, state, base)
        out["base.jl_norm"] = out["base.shapes"] \
            and projection_norm_ok(p, base.projection)
    out["base_public"] = all(out.values())
    out["beta_new_bound"] = \
        1 <= int(rproof.beta_new) <= recursion.beta_new_max(p)
    out["fold_statement"] = out["folded"] = False
    if out["beta_new_bound"] and out["base.shapes"]:
        with _section(timer, "fold_statement"):
            p2, st, _ = recursion.fold_statement(p, state, base, crs, mu,
                                                 kappa_new,
                                                 int(rproof.beta_new))
            out["fold_statement"] = _shapes_ok(p2, rproof.folded)
    if out["fold_statement"]:
        with _section(timer, "folded_verify"):
            rep = verify_report(p2, st, rproof.folded,
                                recursion.folded_crs(crs, p2),
                                decomp_mode="exact", timer=timer)
        out.update({"folded." + k: v for k, v in rep.items()})
        out["folded"] = rep["all_with_bpp"]
    out["all"] = all(out[k] for k in ("base_public", "beta_new_bound",
                                      "fold_statement", "folded"))
    return out

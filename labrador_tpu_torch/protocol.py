"""Shared prover/verifier protocol math (small and big q).

Counterpart of ``labrador_tpu/protocol.py``.  The three CRS-consuming
commitments go through the kernel wrappers (``ops/ajtai_cuda``,
``ops/u1_cuda``, ``ops/cd_cuda``), as the JAX package sends them through
its Pallas kernels on the TPU; everything else is eval-domain tensor
algebra.  With an ``AxisCtx`` the three commitments run sharded over the
rows group of a (dp, rows) mesh (``parallel/``): each rank takes the
range mode of its kernels over its share of kappa (or of the C/D stream)
and one all-gather or all-reduce completes the result.  Where the JAX
package sums per-prime partials in the evaluation domain, the port sums
the kernels' residues as int64 and reduces once mod q; only the results
must match.  At big q the JAX package accumulates the
scalar aggregations per CRT prime and folds once, to avoid 66-bit
products in int32 lanes; here residues are int64 and ``modmath.mulmod``
takes each product of two residues exactly, so both moduli share one code
path.  Only the conventions differ: at big q the digits are signed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import ntt as ntt_ops
from .ops import rq, zq
from .ops.ajtai_cuda import ajtai_commit as _ajtai_kernel
from .ops.cd_cuda import cd_sum
from .ops.decompose import decompose
from .ops.modmath import matmul_mod, mod_pos, mulmod
from .ops.u1_cuda import u1_bterm
from .parallel.collectives import (CollectiveStats, all_gather_cat,
                                   all_reduce_sum)
from .params import LabradorParams, _ceil_log


class AxisCtx(NamedTuple):
    """Collective context of the kappa-sized commitments: the rows
    ``group`` of a mesh, its ``n_shards`` ranks and this rank's ``index``
    among them (its group rank).  ``ajtai_commit`` / ``u1_from_digits`` /
    ``u2_from_digits`` then compute this rank's rows or partials with the
    kernels' range modes and complete them over the group; ``None`` (the
    default) is the single-device path.  ``stats`` records the
    collectives' cost."""

    group: object
    n_shards: int
    index: int
    stats: CollectiveStats | None = None


def _kappa_shard(kappa: int, ctx: AxisCtx) -> tuple[int, int]:
    """(first, count) of this rank's kappa rows or columns; a kappa that
    the rows axis does not divide is refused, as in the JAX package."""
    if kappa % ctx.n_shards:
        raise ValueError(f"kappa={kappa} must divide the rows axis "
                         f"({ctx.n_shards})")
    per = kappa // ctx.n_shards
    return ctx.index * per, per


def _stream_shard(L: int, ctx: AxisCtx) -> tuple[int, int]:
    """(l0, length) of this rank's slice of a stream of L entries, cut as
    the JAX package's ``_cd_sharded_partial`` cuts it: ceil(L / n) entries
    a rank, the last ones short or empty."""
    per = -(-L // ctx.n_shards)
    l0 = min(L, ctx.index * per)
    return l0, min(L, l0 + per) - l0


def _sum_partials(part: torch.Tensor, q: int, ctx: AxisCtx) -> torch.Tensor:
    """The all-reduce of this rank's partial (residues in [0, q)), mod q."""
    return mod_pos(all_reduce_sum(part, ctx.group, ctx.stats), q)


# ---------------------------------------------------------------------------
# First aggregation (proofgen.rs:189-289 / verification.rs:38-89)
# ---------------------------------------------------------------------------

def aggregate_a_pp(a_prime: torch.Tensor, psi: torch.Tensor,
                   q: int) -> torch.Tensor:
    """a''_k = sum_l psi_k[l] a'_l: (L, r, r, d), (ub, L) -> (ub, r, r, d)."""
    terms = mulmod(a_prime[None], psi[:, :, None, None, None], q)
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
        mulmod(phi_prime[None], psi[:, :, None, None, None], p.q), dim=1),
        p.q)
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
    prod = mod_pos(torch.sum(mulmod(omega, projection[None], q), dim=1), q)
    s = mod_pos(torch.sum(mulmod(psi, b_prime[None], q), dim=1), q)
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
    the transcript and a dense ``structs.State`` or a structured
    ``recursion.FoldedState``, whose alpha-contractions stream from its
    base CRS.  Each level is reduced mod q before the next multiplication
    (the CRT-range invariant)."""
    p = params
    plan = ntt_ops.plan_for(p)
    a_pp = aggregate_a_pp(state.a_prime_k[:p.l_count], proof.psi, p.q)
    phi_pp = aggregate_phi_pp(state.phi_prime_k[:p.l_count], proof.psi,
                              proof.omega, proof.pi, p)
    alpha_hat = ntt_ops.ntt_fwd(proof.alpha, plan)
    beta_hat = ntt_ops.ntt_fwd(proof.beta, plan)
    a_pp_hat = ntt_ops.ntt_fwd(a_pp, plan)
    phi_pp_hat = ntt_ops.ntt_fwd(phi_pp, plan)
    if hasattr(state, "phi_alpha_modq"):
        a_beta = ntt_ops.ntt_inv_modq(
            phi_weighted_hat(beta_hat, a_pp_hat, plan), plan)
        a_fin = zq.add(state.a_alpha_modq(proof.alpha), a_beta, p.q)
        phi_beta = ntt_ops.ntt_inv_modq(
            phi_weighted_hat(beta_hat, phi_pp_hat, plan), plan)
        phi_fin = zq.add(state.phi_alpha_modq(proof.alpha), phi_beta, p.q)
    else:
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
    """(..., t, r, r, d) digits -> (..., n_tri, t, d) upper-triangle stream
    in (i <= j, k) order, the CRS C/D column order."""
    p = params
    rows = [mat_dig[..., i, j, :] for i in range(p.r) for j in range(i, p.r)]
    return torch.stack(rows, dim=-3).contiguous()


def ajtai_commit(crs, witness: torch.Tensor,
                 ctx: AxisCtx | None = None) -> torch.Tensor:
    """t_i = A s_i: (r_eff, n, d) residues -> (r_eff, kappa, d).  With
    ``ctx``: this rank's kappa rows of A, then an all-gather along kappa.
    For a ``crs.CRSBatch`` every tensor leads with its instances, here and
    in ``u1_from_digits`` / ``u2_from_digits``: one launch of each kernel
    for the batch (the JAX package's vmap), every instance taking the same
    range under ``ctx``."""
    if ctx is None:
        return _ajtai_kernel(crs, witness.contiguous())
    row0, rows = _kappa_shard(crs.params.kappa, ctx)
    t_loc = _ajtai_kernel(crs, witness.contiguous(), row0, rows)
    return all_gather_cat(t_loc, t_loc.dim() - 2, ctx.group, ctx.stats)


def u1_from_digits(crs, t_dig: torch.Tensor, g_dig: torch.Tensor,
                   params: LabradorParams,
                   ctx: AxisCtx | None = None) -> torch.Tensor:
    """u1 = sum_{i,k} B_ik t_i^(k) + sum_{i<=j,k} C_ijk g_ij^(k) -> (kappa_1, d).
    With ``ctx``: the B-term over this rank's kappa columns of every B_ik
    plus the C-term over its slice of the (tri, k) stream, then one
    all-reduce (the rayon loop of proofgen.rs:101-124, over ranks)."""
    p = params
    g_stream = _tri_stream(g_dig, p)
    if ctx is None:
        bterm = u1_bterm(crs, t_dig.contiguous())
        cterm = cd_sum(crs, g_stream, crs._off_c, p.t_2, p.b_2)
        return zq.add(bterm, cterm, p.q)
    col0, ncols = _kappa_shard(p.kappa, ctx)
    l0, length = _stream_shard(g_stream.shape[-3] * p.t_2, ctx)
    part = u1_bterm(crs, t_dig.contiguous(), col0, ncols) \
        + cd_sum(crs, g_stream, crs._off_c, p.t_2, p.b_2, l0, length)
    return _sum_partials(part, p.q, ctx)


def u2_from_digits(crs, h_dig: torch.Tensor, params: LabradorParams,
                   ctx: AxisCtx | None = None) -> torch.Tensor:
    """u2 = sum_{i<=j, k<t_1} D_ijk h_ij^(k) -> (kappa_2, d).  With
    ``ctx``: this rank's slice of the (tri, k) stream, then one
    all-reduce (the verifier-side rayon site, verification.rs:372-415)."""
    p = params
    h_stream = _tri_stream(h_dig, p)
    if ctx is None:
        return cd_sum(crs, h_stream, crs._off_d, p.t_1)
    l0, length = _stream_shard(h_stream.shape[-3] * p.t_1, ctx)
    part = cd_sum(crs, h_stream, crs._off_d, p.t_1, 0, l0, length)
    return _sum_partials(part, p.q, ctx)


# ---------------------------------------------------------------------------
# Decompositions
# ---------------------------------------------------------------------------

def _decompose_protocol(x: torch.Tensor, base: int, ndig: int, q: int,
                        mode: str) -> torch.Tensor:
    """Digits stored as residues mod q; 'exact' decomposes the centred
    representative.  At big q always the exact balanced digits, kept signed
    (``zq.decompose_balanced_big``): the reference mode has nothing to be
    bit-compatible with there, as in the JAX package."""
    if zq.is_big(q):
        return zq.decompose_balanced_big(x, base, ndig, q)
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

"""Recursive proof composition: fold a proof into a new LaBRADOR instance.

Counterpart of ``labrador_tpu/recursion.py`` (its ``ctx=None`` branches)
at small and big q.  At big q the JAX package's ``Zq2`` branches (the
residue-fold ``_scale_modq``, the lift of the signed challenges before the
subtraction) are one int64 code path here: products of two residues go
through ``modmath.mulmod``, and the digit witness, like the challenges,
stays signed, as in the JAX package.
The verifier's algebraic checks become a new principal relation whose
witness is the exact centred digit decomposition of the amortized opening
(z, t, g, h), so the base proof must use ``exact_digits=True`` params and
``decomp_mode='exact'``.  Layout, relation and norm bookkeeping follow the
JAX module, whose docstring derives them:

  vectors  = nz z-digit vectors, then mu vectors holding the t/g/h digit
             stream, padded to rank n'
  families = kappa rows of A z = sum c_i t_i, kappa_1 rows of u1,
             kappa_2 rows of u2, <z,z>, sum <phi_i,z> c_i, and the b row.

``fold`` returns the structured relation (``FoldedState``), whose
alpha-contractions stream the base CRS (on CUDA through the stream kernel
of ``ops/alpha_cuda``); ``recursive_step`` builds the dense
relation (tests only, it grows with kappa x M).  ``fold`` is two halves:
``build_witness`` (the prover's, from the opening z, t, g, h) and
``fold_statement`` (anyone's, from the transcript's other fields, the
base CRS and the public beta'), which ``verifier.verify_recursive``
runs alone.  Ring products of
coefficient tensors go through ``ops.polymul_cuda.negacyclic_polymul``:
the fused polymul kernel on the card at small q, the CRT transforms in
torch ops at big q (the JAX package's XLA route there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import protocol
from .crs import CRS
from .ops import alpha_cuda
from .ops import ntt as ntt_ops
from .ops import polymul_cuda
from .ops import zq
from .ops.modmath import mod_pos, mulmod
from .params import LabradorParams, _ceil_log
from .structs import State, Transcript, gram_hat

# The CLI's CRS seeds, the JAX CLI's (its golden files fix them): the
# base instance's CRS from seed * CRS_SEED_MULT mod 2^64, the folded
# instance's from seed ^ FOLDED_CRS_XOR.  Kept here alone: ``cli`` imports
# them, and ``folded_crs`` reads the seed back from a base CRS's key.
CRS_SEED_MULT = 0x9E3779B97F4A7C15
FOLDED_CRS_XOR = 0xF01D


# Calls and base-CRS entries of the alpha-contractions, and those of the
# kernel route (``ops/alpha_cuda.ExpansionCount``)
ALPHA_EXPANSION = alpha_cuda.EXPANSION


def folded_crs(base_crs: CRS, params_new: LabradorParams) -> CRS:
    """The folded instance's CRS, derived from the base CRS alone by the
    CLI's convention: the base key is seed * CRS_SEED_MULT mod 2^64
    (CRS_SEED_MULT is odd, so the seed is the key times its inverse), and
    the folded CRS is made from seed ^ FOLDED_CRS_XOR.  That is the JAX
    CLI's rule, which the golden ``-R`` files hold; for a base CRS made
    by any other seed rule the result is still a fixed function of the
    base key, the same for prover and verifier, but its seed means
    nothing."""
    base_seed = (int(base_crs.key[0]) << 32) | int(base_crs.key[1])
    seed = base_seed * pow(CRS_SEED_MULT, -1, 1 << 64) % (1 << 64)
    return CRS.create(params_new, seed=seed ^ FOLDED_CRS_XOR)


def _exact_digits_lifted(x: torch.Tensor, base: int, ndig: int,
                         q: int) -> torch.Tensor:
    """Exact centred digits lifted to residues mod q (signed at big q): the
    digits the prover committed to in u1/u2 (``decomp_mode='exact'``)."""
    return protocol._decompose_protocol(x, base, ndig, q, "exact")


def _powers(base: int, count: int, q: int) -> list[int]:
    return [pow(base, k, q) for k in range(count)]


@dataclass(frozen=True)
class RecursionLayout:
    """Index bookkeeping for the new witness."""

    params: LabradorParams        # base params
    nz: int                       # z digits: ceil_log_b(q)
    mu: int
    n_new: int
    r_new: int
    garbage_len: int              # ring elements in the t/g/h stream
    k_new: int

    @property
    def m_total(self) -> int:
        return self.r_new * self.n_new

    def z_pos(self, k: int, l: int) -> int:
        return k * self.n_new + l

    def garbage_pos(self, g_idx: int) -> int:
        return self.nz * self.n_new + g_idx

    # garbage stream order: t digits (i, k, row), then g digits (i<=j, k),
    # then h digits (i<=j, k)
    def t_pos(self, i: int, k: int, row: int) -> int:
        p = self.params
        return self.garbage_pos((i * p.t_1 + k) * p.kappa + row)

    def _tri_base(self) -> int:
        p = self.params
        return p.r * p.t_1 * p.kappa

    def g_pos(self, i: int, j: int, k: int) -> int:
        p = self.params
        tri = i * p.r - i * (i - 1) // 2 + (j - i)
        return self.garbage_pos(self._tri_base() + tri * p.t_2 + k)

    def h_pos(self, i: int, j: int, k: int) -> int:
        p = self.params
        n_tri = p.r * (p.r + 1) // 2
        tri = i * p.r - i * (i - 1) // 2 + (j - i)
        return self.garbage_pos(self._tri_base() + n_tri * p.t_2
                                + tri * p.t_1 + k)


def make_layout(params: LabradorParams, mu: int = 0) -> RecursionLayout:
    p = params
    if not p.exact_digits:
        raise ValueError("recursion requires exact_digits=True base params")
    nz = _ceil_log(p.q, p.b)
    n_tri = p.r * (p.r + 1) // 2
    garbage = p.r * p.t_1 * p.kappa + n_tri * p.t_2 + n_tri * p.t_1
    if mu <= 0:
        mu = max(1, int(round(math.sqrt(garbage))))     # n' ~ sqrt(garbage)
    n_new = max(p.n, -(-garbage // mu))
    return RecursionLayout(params=p, nz=nz, mu=mu, n_new=n_new,
                           r_new=nz + mu, garbage_len=garbage,
                           k_new=p.kappa + p.kappa_1 + p.kappa_2 + 3)


def build_witness(layout: RecursionLayout, proof: Transcript) -> torch.Tensor:
    """(r_new, n_new, d) new witness: lifted exact centred digits."""
    p = layout.params
    q, d = p.q, p.d
    z_dig = _exact_digits_lifted(proof.z, p.b, layout.nz, q)   # (nz, n, d)
    t_dig = _exact_digits_lifted(proof.t, p.b_1, p.t_1, q)     # (t1,r,kap,d)
    g_dig = _exact_digits_lifted(proof.g, p.b_2, p.t_2, q)     # (t2,r,r,d)
    h_dig = _exact_digits_lifted(proof.h, p.b_1, p.t_1, q)     # (t1,r,r,d)
    flat = torch.zeros((layout.m_total, d), dtype=torch.int64,
                       device=proof.z.device)
    for k in range(layout.nz):
        pos = layout.z_pos(k, 0)
        flat[pos:pos + p.n] = z_dig[k]
    garbage = torch.cat([
        torch.swapaxes(t_dig, 0, 1).reshape(-1, d),             # (i, k, row)
        protocol._tri_stream(g_dig, p).reshape(-1, d),          # (tri, k)
        protocol._tri_stream(h_dig, p).reshape(-1, d)])
    assert garbage.shape[0] == layout.garbage_len
    g0 = layout.garbage_pos(0)
    flat[g0:g0 + layout.garbage_len] = garbage
    return flat.reshape(layout.r_new, layout.n_new, d)


# a (*) b mod q, broadcasting: the fused polymul kernel on the card at
# small q, the CRT route at big q (ops/polymul_cuda.py)
_ring_mul_modq = polymul_cuda.negacyclic_polymul


def _scale_modq(x: torch.Tensor, const: int, q: int) -> torch.Tensor:
    """x * const mod q for canonical (or small signed) x."""
    return mulmod(x, int(const) % q, q)


def _scale_many_modq(x: torch.Tensor, w: np.ndarray, q: int) -> torch.Tensor:
    """x (..., d) canonical times a static integer weight table w (numpy,
    any integer or Python-object entries, broadcastable against
    x.shape[:-1]) -> canonical mod q.  The weights are reduced mod q in
    Python integers first."""
    w = np.vectorize(lambda v: int(v) % q, otypes=[np.int64])(np.asarray(w))
    wt = torch.as_tensor(w, dtype=torch.int64).to(x.device)[..., None]
    return mulmod(x, wt, q)


def _res_scale(res: torch.Tensor, const: int, plan) -> torch.Tensor:
    """Per-prime residues (P, ...) times the integer const, mod each prime."""
    c = torch.tensor([const % pr for pr in plan.primes], dtype=torch.int64,
                     device=res.device)
    return mod_pos(res * c.reshape((-1,) + (1,) * (res.ndim - 1)),
                   plan.pv(res.device, res.ndim))


def witness_beta(witness: torch.Tensor, q: int) -> int:
    """beta' of a digit witness: sqrt(2) over its actual norm (headroom
    for the JL bound, see the JAX module), isqrt(2 ||w||^2) + 1."""
    wc = zq.to_signed_small(witness, q)
    return math.isqrt(2 * int(torch.sum(wc * wc))) + 1


def beta_new_max(params: LabradorParams) -> int:
    """The largest beta' that ``witness_beta`` gives when the base's check
    14 holds: the digit stream is part of check 14's digits (g and h once
    per i <= j), so ||w||^2 <= beta'^2 of the base."""
    return math.isqrt(2 * int(params.beta_prime)) + 1


def folded_params(layout: RecursionLayout, kappa_new: int,
                  beta_new: int) -> LabradorParams:
    """The new instance's params, with the norm bound beta_new."""
    p = layout.params
    return LabradorParams(n=layout.n_new, r=layout.r_new, q=p.q, d=p.d,
                          k_count=layout.k_new, l_count=1,
                          kappa_override=kappa_new, exact_digits=True,
                          beta_override=beta_new)


# ---------------------------------------------------------------------------
# Dense relation (tests; memory grows as k' x M x d)
# ---------------------------------------------------------------------------

def build_relation(layout: RecursionLayout, state: State, proof: Transcript,
                   crs: CRS):
    """Constraint families (a_new (k', r', r', d), phi_new (k', r', n', d),
    b_new (k', d)) over the new witness, assembled in per-prime residue form
    and folded to canonical residues once at the end (every entry is the
    residue of an integer |v| < q^2, exact)."""
    p = layout.params
    q, d = p.q, p.d
    plan = ntt_ops.plan_for(p)
    P = plan.n_primes
    kp, M = layout.k_new, layout.m_total
    dev = proof.z.device

    def res_of(x):
        return zq.to_res(x, plan)

    def const_res(v: int):
        return torch.tensor([v % pr for pr in plan.primes],
                            dtype=torch.int64, device=dev)

    phi = torch.zeros((P, kp, M, d), dtype=torch.int64, device=dev)
    b_new = torch.zeros((P, kp, d), dtype=torch.int64, device=dev)
    a_new = torch.zeros((P, kp, layout.r_new, layout.r_new, d),
                        dtype=torch.int64, device=dev)

    a_fin, phi_fin, b_fin = protocol.canonical_aggregates(p, state, proof)
    c = proof.c
    c_hat = ntt_ops.ntt_fwd(c, plan)
    bpow = _powers(p.b, layout.nz, q)
    b1pow = _powers(p.b_1, p.t_1, q)
    b2pow = _powers(p.b_2, p.t_2, q)
    tri = [(i, j) for i in range(p.r) for j in range(i, p.r)]

    # group 1: kappa rows of A z - sum_i c_i t_i = 0
    a_res = res_of(crs.a_rows(device=dev))               # (P, kappa, n, d)
    for k in range(layout.nz):
        pos = layout.z_pos(k, 0)
        phi[:, :p.kappa, pos:pos + p.n] = _res_scale(a_res, bpow[k], plan)
    c_res = res_of(c)                                    # (P, r, d)
    rows = torch.arange(p.kappa, device=dev)
    for i in range(p.r):
        for k2 in range(p.t_1):
            coeff = _res_scale(-c_res[:, i], b1pow[k2], plan)     # (P, d)
            pos0 = layout.t_pos(i, k2, 0)
            phi[:, rows, pos0 + rows] = coeff[:, None, :].expand(
                P, p.kappa, d)

    # group 2: kappa_1 rows of u1 = sum B t + sum C g
    row1 = p.kappa
    for i in range(p.r):
        for k in range(p.t_1):
            pos0 = layout.t_pos(i, k, 0)
            phi[:, row1:row1 + p.kappa_1, pos0:pos0 + p.kappa] = res_of(
                crs.b_rows(i, k, device=dev))
    for i, j in tri:
        for k in range(p.t_2):
            phi[:, row1:row1 + p.kappa_1, layout.g_pos(i, j, k)] = res_of(
                crs.c_vec(i, j, k, device=dev))
    b_new[:, row1:row1 + p.kappa_1] = res_of(proof.u_1)

    # group 3: kappa_2 rows of u2 = sum D h
    row2 = row1 + p.kappa_1
    for i, j in tri:
        for k in range(p.t_1):
            phi[:, row2:row2 + p.kappa_2, layout.h_pos(i, j, k)] = res_of(
                crs.d_vec(i, j, k, device=dev))
    b_new[:, row2:row2 + p.kappa_2] = res_of(proof.u_2)

    # family 16: <z,z> - sum_ij g_ij c_i c_j = 0
    f16 = row2 + p.kappa_2
    for k in range(layout.nz):
        for k2 in range(layout.nz):
            a_new[:, f16, k, k2, 0] = const_res(bpow[k] * bpow[k2] % q)
    cc_res = res_of(_ring_mul_modq(c[:, None], c[None, :], plan))  # (P,r,r,d)
    for i, j in tri:
        mult = 1 if i == j else 2
        for k in range(p.t_2):
            phi[:, f16, layout.g_pos(i, j, k)] = _res_scale(
                -cc_res[:, i, j], mult * b2pow[k] % q, plan)

    # family 17: sum_i <phi_i, z> c_i - sum h c c = 0
    f17 = f16 + 1
    phi_fin_hat = ntt_ops.ntt_fwd(phi_fin, plan)         # (P, r, n, d)
    cphi_res = res_of(ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(c_hat[:, :, None, :], phi_fin_hat, plan), plan,
        axis=1), plan))                                  # (P, n, d)
    for k in range(layout.nz):
        pos = layout.z_pos(k, 0)
        phi[:, f17, pos:pos + p.n] = _res_scale(cphi_res, bpow[k], plan)
    for i, j in tri:
        mult = 1 if i == j else 2
        for k in range(p.t_1):
            phi[:, f17, layout.h_pos(i, j, k)] = _res_scale(
                -cc_res[:, i, j], mult * b1pow[k] % q, plan)

    # family 18: sum a_ij g_ij + sum h_ii = b
    f18 = f17 + 1
    a_fin_res = res_of(a_fin)                            # (P, r, r, d)
    for i, j in tri:
        mult = 1 if i == j else 2
        for k in range(p.t_2):
            phi[:, f18, layout.g_pos(i, j, k)] = _res_scale(
                a_fin_res[:, i, j], mult * b2pow[k] % q, plan)
    for i in range(p.r):
        for k in range(p.t_1):
            phi[:, f18, layout.h_pos(i, i, k), 0] = const_res(b1pow[k])
    b_new[:, f18] = res_of(b_fin)

    a_new_q = zq.fold_res_modq(a_new, plan, signed=True)
    phi_q = zq.fold_res_modq(phi, plan, signed=True)
    b_q = zq.fold_res_modq(b_new, plan, signed=True)
    return a_new_q, phi_q.reshape(kp, layout.r_new, layout.n_new, d), b_q


def relation_residual(a_k: torch.Tensor, phi_k: torch.Tensor,
                      b_k: torch.Tensor, witness: torch.Tensor,
                      params_new: LabradorParams) -> int:
    """max over families of (sum_ij a <w_i,w_j> + sum <phi_i,w_i> - b) mod
    q: 0 iff the witness satisfies the relation."""
    plan = ntt_ops.plan_for(params_new)
    d = params_new.d
    P = plan.n_primes
    K = a_k.shape[0]
    w_hat = ntt_ops.ntt_fwd(witness, plan)
    g = ntt_ops.ntt_inv_modq(gram_hat(w_hat, plan), plan)
    g_hat = ntt_ops.ntt_fwd(g, plan)
    t1 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(
        ntt_ops.ntt_fwd(a_k, plan), g_hat[:, None], plan).reshape(
            P, K, -1, d), plan, axis=2)
    t2 = ntt_ops._mod_sum_p(ntt_ops.eval_mul(
        ntt_ops.ntt_fwd(phi_k, plan), w_hat[:, None], plan).reshape(
            P, K, -1, d), plan, axis=2)
    lhs = ntt_ops.ntt_inv_modq(ntt_ops.eval_add(t1, t2, plan), plan)
    return int(torch.max(zq.sub(lhs, b_k, params_new.q)))


def recursive_step(params: LabradorParams, state: State, proof: Transcript,
                   crs: CRS, mu: int = 0, kappa_new: int = 16):
    """Fold a proof into a new instance with the dense relation.  Returns
    (params_new, witness_new, state_new, layout)."""
    layout = make_layout(params, mu)
    witness = build_witness(layout, proof)
    a_new, phi_new, b_new = build_relation(layout, state, proof, crs)
    state_new = State(a_k=a_new, phi_k=phi_new, b_k=b_new,
                      a_prime_k=a_new, phi_prime_k=phi_new,
                      b_prime_k=b_new[:, 0])
    params_new = folded_params(layout, kappa_new,
                               witness_beta(witness, params.q))
    return params_new, witness, state_new, layout


# ---------------------------------------------------------------------------
# Structured folded relation: the CRS-derived phi blocks are streamed from
# the base CRS whenever the protocol needs sum_k alpha_k phi_k, in O(M d)
# memory; the dense (k', M, d) tensor never exists.
# ---------------------------------------------------------------------------

def _alpha_contract_a(crs: CRS, w: torch.Tensor,
                      p0: LabradorParams) -> torch.Tensor:
    """sum_rho w_rho * A[rho] -> (n, d) mod q, w (kappa, d)."""
    return alpha_cuda.alpha_a(crs, w)


def _alpha_contract_b(crs: CRS, w: torch.Tensor,
                      p0: LabradorParams) -> torch.Tensor:
    """S_B[m] = sum_rho w_rho * B_m[rho, col] for all m = i * t_1 + k ->
    (r, t_1, kappa, d) mod q, w (kappa_1, d)."""
    return alpha_cuda.alpha_b(crs, w).reshape(p0.r, p0.t_1, p0.kappa, p0.d)


def _alpha_contract_cd(crs: CRS, base: int, w: torch.Tensor, t_used: int,
                       p0: LabradorParams) -> torch.Tensor:
    """S[tri, k] = <w, M_{tri,k}> over the kappa_2 rows of the C/D column
    vectors at base + (k + t_1 * tri) * kappa_2 * d (the t_1-stride quirk)
    -> (n_tri, t_used, d) mod q, w (kappa_2, d)."""
    n_tri = p0.r * (p0.r + 1) // 2
    return alpha_cuda.alpha_cd(crs, base, w, t_used).reshape(n_tri, t_used,
                                                             p0.d)


@dataclass(eq=False)
class FoldedState:
    """The folded principal relation in structured form, in the place of
    ``structs.State`` for the prover and verifier: the CRS-derived blocks
    are re-streamed from ``base_crs`` (``phi_alpha_modq``) and the
    transcript-derived blocks are carried as small tensors."""

    base_crs: CRS                # CRS of the base instance
    c: torch.Tensor              # (r, d) amortized-opening challenges
    cc: torch.Tensor             # (r, r, d) c_i * c_j mod q
    cphi: torch.Tensor           # (n, d) sum_i c_i * phi_fin_i mod q
    a_fin: torch.Tensor          # (r, r, d) canonical aggregate a
    phi0: torch.Tensor           # (1, r', n', d) dense family-0 row (F')
    b_k: torch.Tensor            # (k', d) right-hand sides
    layout: RecursionLayout

    @property
    def q(self) -> int:
        return self.layout.params.q

    @property
    def a_prime_k(self) -> torch.Tensor:
        lay = self.layout
        return torch.zeros((1, lay.r_new, lay.r_new, lay.params.d),
                           dtype=torch.int64, device=self.b_k.device)

    @property
    def phi_prime_k(self) -> torch.Tensor:
        return self.phi0

    @property
    def b_prime_k(self) -> torch.Tensor:
        # family 0 is a group-A row: b = 0; F' takes the constant term
        return self.b_k[0:1, 0]

    def _alpha_split(self, alpha: torch.Tensor):
        p0 = self.layout.params
        k0, k1, k2 = p0.kappa, p0.kappa_1, p0.kappa_2
        base = k0 + k1 + k2
        return (alpha[:k0], alpha[k0:k0 + k1], alpha[k0 + k1:base],
                alpha[base], alpha[base + 1], alpha[base + 2])

    def phi_alpha_modq(self, alpha: torch.Tensor) -> torch.Tensor:
        """sum_k alpha_k phi_k -> (r', n', d) canonical mod q: one A pass,
        one B pass and the C/D columns of the base CRS (on CUDA one
        stream-kernel launch each, ``ops/alpha_cuda``)."""
        lay = self.layout
        p0 = lay.params
        q, d = p0.q, p0.d
        plan = ntt_ops.plan_for(p0)
        crs = self.base_crs
        aA, aB, aC, a16, a17, a18 = self._alpha_split(alpha)
        aA_hat = ntt_ops.ntt_fwd(aA, plan)
        c_hat = ntt_ops.ntt_fwd(self.c, plan)
        bpow = _powers(p0.b, lay.nz, q)
        b1pow = _powers(p0.b_1, p0.t_1, q)
        b2pow = _powers(p0.b_2, p0.t_2, q)
        flat = torch.zeros((lay.m_total, d), dtype=torch.int64,
                           device=alpha.device)

        # z blocks: bpow_k * (sum_rho aA_rho A[rho] + a17 * cphi)
        s_a = _alpha_contract_a(crs, aA, p0)                    # (n, d)
        zc = zq.add(s_a, _ring_mul_modq(a17, self.cphi, plan), q)
        for k in range(lay.nz):
            pos = lay.z_pos(k, 0)
            flat[pos:pos + p0.n] = _scale_modq(zc, bpow[k], q)

        # t digit blocks: S_B[i, k2, col] - b1pow_k2 * (aA_col * c_i)
        s_b = _alpha_contract_b(crs, aB, p0)                    # (r,t1,kap,d)
        ac = ntt_ops.ntt_inv_modq(ntt_ops.eval_mul(
            aA_hat[:, :, None, :], c_hat[:, None, :, :], plan), plan)
        ac_t = torch.swapaxes(ac, 0, 1)                        # (r, kap, d)
        t_blk = torch.stack([
            zq.sub(s_b[:, k2], _scale_modq(ac_t, b1pow[k2], q), q)
            for k2 in range(p0.t_1)], dim=1)                   # (r,t1,kap,d)
        g0 = lay.garbage_pos(0)
        t_len = p0.r * p0.t_1 * p0.kappa
        flat[g0:g0 + t_len] = t_blk.reshape(t_len, d)

        # g digit blocks: <aB, C_tri,k> + (mult b2pow_k)(a18 a_fin - a16 cc)
        # h digit blocks: <aC, D_tri,k> - (mult b1pow_k) a17 cc
        #                 + [i == j] b1pow_k a18
        s_c = _alpha_contract_cd(crs, crs._off_c, aB, p0.t_2, p0)
        g_base = zq.sub(_ring_mul_modq(a18, self.a_fin, plan),
                        _ring_mul_modq(a16, self.cc, plan), q)  # (r, r, d)
        s_d = _alpha_contract_cd(crs, crs._off_d, aC, p0.t_1, p0)
        h_base = zq.sub(torch.zeros_like(self.cc),
                        _ring_mul_modq(a17, self.cc, plan), q)
        iu, ju = np.triu_indices(p0.r)
        n_tri = iu.shape[0]
        mult = np.where(iu == ju, 1, 2).astype(object)
        wg = mult[:, None] * np.asarray(b2pow, object)[None, :]  # (tri, t2)
        wh = mult[:, None] * np.asarray(b1pow, object)[None, :]  # (tri, t1)
        wdiag = (iu == ju).astype(object)[:, None] \
            * np.asarray(b1pow, object)[None, :]
        ti, tj = (torch.from_numpy(x).to(alpha.device) for x in (iu, ju))
        g_tri = g_base[ti, tj].reshape(n_tri, 1, d)
        h_tri = h_base[ti, tj].reshape(n_tri, 1, d)
        vals_g = zq.add(s_c, _scale_many_modq(g_tri, wg, q), q)
        vals_h = zq.add(s_d, _scale_many_modq(h_tri, wh, q), q)
        vals_h = zq.add(vals_h, _scale_many_modq(a18.reshape(1, 1, d), wdiag,
                                                 q), q)
        g0s = lay.garbage_pos(lay._tri_base())
        flat[g0s:g0s + n_tri * p0.t_2] = vals_g.reshape(-1, d)
        h0s = g0s + n_tri * p0.t_2
        flat[h0s:h0s + n_tri * p0.t_1] = vals_h.reshape(-1, d)
        return flat.reshape(lay.r_new, lay.n_new, d)

    def a_alpha_modq(self, alpha: torch.Tensor) -> torch.Tensor:
        """sum_k alpha_k a_k -> (r', r', d) mod q: only the <z,z> family
        (f16) is quadratic, a[f16][k, k2] = b^k b^k2."""
        lay = self.layout
        p0 = lay.params
        q, d = p0.q, p0.d
        a16 = self._alpha_split(alpha)[3]
        bpow = _powers(p0.b, lay.nz, q)
        out = torch.zeros((lay.r_new, lay.r_new, d), dtype=torch.int64,
                          device=alpha.device)
        for k in range(lay.nz):
            for k2 in range(lay.nz):
                out[k, k2] = _scale_modq(a16, bpow[k] * bpow[k2] % q, q)
        return out


def fold_statement(params: LabradorParams, state, proof: Transcript,
                   crs: CRS, mu: int, kappa_new: int, beta_new: int):
    """The folded statement alone, as a verifier rebuilds it: (params_new,
    FoldedState, layout).  Reads the transcript's public fields only (u_1,
    u_2, c and those of the aggregations: pi, projection, psi, omega, b'',
    alpha, beta), never the opening z, t, g, h; ``beta_new`` is the new
    instance's norm bound, which the recursive proof carries.  ``state``
    may itself be a FoldedState (multi-level recursion)."""
    p = params
    layout = make_layout(p, mu)
    plan = ntt_ops.plan_for(p)
    q, d = p.q, p.d
    dev = proof.u_1.device

    a_fin, phi_fin, b_fin = protocol.canonical_aggregates(p, state, proof)
    c = proof.c
    cc = _ring_mul_modq(c[:, None], c[None, :], plan)          # (r, r, d)
    c_hat = ntt_ops.ntt_fwd(c, plan)
    cphi = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(ntt_ops.eval_mul(
        c_hat[:, :, None, :], ntt_ops.ntt_fwd(phi_fin, plan), plan), plan,
        axis=1), plan)                                          # (n, d)

    # dense family-0 row (the single F' family): group-A row rho = 0
    bpow = _powers(p.b, layout.nz, q)
    b1pow = _powers(p.b_1, p.t_1, q)
    flat0 = torch.zeros((layout.m_total, d), dtype=torch.int64, device=dev)
    a_row0 = crs.a_rows(0, 1, device=dev)[0]                    # (n, d)
    for k in range(layout.nz):
        pos = layout.z_pos(k, 0)
        flat0[pos:pos + p.n] = _scale_modq(a_row0, bpow[k], q)
    neg_c = zq.sub(torch.zeros_like(c), c, q)
    for i in range(p.r):
        for k2 in range(p.t_1):
            flat0[layout.t_pos(i, k2, 0)] = _scale_modq(neg_c[i], b1pow[k2],
                                                        q)
    phi0 = flat0.reshape(1, layout.r_new, layout.n_new, d)

    # dense right-hand sides (k', d): 0 | u1 | u2 | 0 | 0 | b_fin
    b_k = torch.zeros((layout.k_new, d), dtype=torch.int64, device=dev)
    row1 = p.kappa
    row2 = row1 + p.kappa_1
    b_k[row1:row1 + p.kappa_1] = proof.u_1
    b_k[row2:row2 + p.kappa_2] = proof.u_2
    b_k[row2 + p.kappa_2 + 2] = b_fin

    st = FoldedState(base_crs=crs, c=c, cc=cc, cphi=cphi, a_fin=a_fin,
                     phi0=phi0, b_k=b_k, layout=layout)
    return folded_params(layout, kappa_new, beta_new), st, layout


def fold(params: LabradorParams, state, proof: Transcript, crs: CRS,
         mu: int = 0, kappa_new: int = 16):
    """Fold a proof into a new instance without the dense relation:
    ``build_witness`` of the opening, its beta' (``witness_beta``), then
    ``fold_statement``.  Returns (params_new, witness_new, FoldedState,
    layout); ``state`` may itself be a FoldedState (multi-level
    recursion)."""
    layout = make_layout(params, mu)
    witness = build_witness(layout, proof)
    params_new, st, layout = fold_statement(
        params, state, proof, crs, mu, kappa_new,
        witness_beta(witness, params.q))
    return params_new, witness, st, layout


def folded_residual(st: FoldedState, witness: torch.Tensor,
                    params_new: LabradorParams) -> int:
    """Exact residual of the folded relation on a digit witness: z, t, g, h
    are recomposed from the witness layout and the base verifier's algebra
    (A z, u1, u2, f16-f18) is replayed against the carried right-hand
    sides.  The max over the six groups of (lhs - rhs) mod q: 0 iff the
    witness satisfies the relation.  O(CRS) memory."""
    lay = st.layout
    p0 = lay.params
    q, d = p0.q, p0.d
    plan = ntt_ops.plan_for(p0)
    P = plan.n_primes
    flat = witness.reshape(lay.m_total, d)
    dev = flat.device
    bpow = _powers(p0.b, lay.nz, q)
    b1pow = _powers(p0.b_1, p0.t_1, q)
    b2pow = _powers(p0.b_2, p0.t_2, q)

    # recompose z, t, g, h mod q from their digit positions
    z = torch.zeros((p0.n, d), dtype=torch.int64, device=dev)
    for k in range(lay.nz):
        pos = lay.z_pos(k, 0)
        z = zq.add(z, _scale_modq(flat[pos:pos + p0.n], bpow[k], q), q)
    g0 = lay.garbage_pos(0)
    t_len = p0.r * p0.t_1 * p0.kappa
    t_dig = torch.swapaxes(flat[g0:g0 + t_len].reshape(
        p0.r, p0.t_1, p0.kappa, d), 0, 1).contiguous()  # (t1, r, kap, d)
    t = torch.zeros((p0.r, p0.kappa, d), dtype=torch.int64, device=dev)
    for k in range(p0.t_1):
        t = zq.add(t, _scale_modq(t_dig[k], b1pow[k], q), q)
    iu, ju = (torch.from_numpy(x).to(dev) for x in np.triu_indices(p0.r))
    n_tri = iu.shape[0]
    g0s = lay.garbage_pos(lay._tri_base())
    h0s = g0s + n_tri * p0.t_2

    def symmetric_digits(start: int, ndig: int) -> torch.Tensor:
        """(ndig, r, r, d) digits from the (tri, k) stream at ``start``."""
        tri = torch.swapaxes(flat[start:start + n_tri * ndig].reshape(
            n_tri, ndig, d), 0, 1)
        out = torch.zeros((ndig, p0.r, p0.r, d), dtype=torch.int64,
                          device=dev)
        out[:, iu, ju] = tri
        out[:, ju, iu] = tri
        return out

    g_dig = symmetric_digits(g0s, p0.t_2)
    h_dig = symmetric_digits(h0s, p0.t_1)
    g = torch.zeros((p0.r, p0.r, d), dtype=torch.int64, device=dev)
    h = torch.zeros_like(g)
    for k in range(p0.t_2):
        g = zq.add(g, _scale_modq(g_dig[k], b2pow[k], q), q)
    for k in range(p0.t_1):
        h = zq.add(h, _scale_modq(h_dig[k], b1pow[k], q), q)

    crs = st.base_crs
    diffs = []

    def diff(a_, b_):
        diffs.append(int(torch.max(zq.sub(a_, b_, q))))

    def contract(x_hat, y_hat):
        """sum over all but the last axis of x (*) y, reduced mod q."""
        return ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(ntt_ops.eval_mul(
            x_hat, y_hat, plan).reshape(P, -1, d), plan, axis=1), plan)

    # group A: A z == sum_i c_i t_i
    az = protocol.ajtai_commit(crs, z[None])[0]
    c_hat = ntt_ops.ntt_fwd(st.c, plan)
    ct = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(ntt_ops.eval_mul(
        c_hat[:, :, None, :], ntt_ops.ntt_fwd(t, plan), plan), plan,
        axis=1), plan)
    diff(az, ct)
    # group B: u1 == B t_dig + C g_dig;  group C: u2 == D h_dig
    row2 = p0.kappa + p0.kappa_1
    diff(protocol.u1_from_digits(crs, t_dig, g_dig, p0),
         st.b_k[p0.kappa:row2])
    diff(protocol.u2_from_digits(crs, h_dig, p0),
         st.b_k[row2:row2 + p0.kappa_2])
    # f16: <z,z> == sum_ij cc_ij g_ij;  f17: <cphi, z> == sum_ij cc_ij h_ij
    cc_hat = ntt_ops.ntt_fwd(st.cc, plan)
    g_hat = ntt_ops.ntt_fwd(g, plan)
    diff(ntt_ops.polyvec_inner_product(z, z, plan), contract(cc_hat, g_hat))
    diff(ntt_ops.polyvec_inner_product(st.cphi, z, plan),
         contract(cc_hat, ntt_ops.ntt_fwd(h, plan)))
    # f18: sum_ij a_fin_ij g_ij + sum_i h_ii == b_fin
    lhs18 = contract(ntt_ops.ntt_fwd(st.a_fin, plan), g_hat)
    hdiag = mod_pos(torch.sum(torch.diagonal(h, dim1=0, dim2=1), dim=1), q)
    diff(zq.add(lhs18, hdiag, q), st.b_k[row2 + p0.kappa_2 + 2])
    return max(diffs)

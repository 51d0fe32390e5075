"""One level of recursive composition, the plain reference of the
program's ``prover.prove_recursive`` and ``verifier.verify_recursive``.

The base proof's opening (z, t, g, h) becomes the witness of a new
instance: its exact balanced digits, the nz = ceil_log_b(q) digit vectors
of z, then mu vectors holding the t, g and h digits in one stream (t in
(i, k, row) order, then g and h over i <= j in (tri, k) order), padded to
rank n' = max(n, ceil(garbage / mu)).  The new relation has k' = kappa +
kappa_1 + kappa_2 + 3 families, which replay the base verifier's algebra:

  group A  kappa rows:   bpow_k A[rho] on the z digits, -c_i b1pow_k on
                         the digit t_i^(k)[rho]                        = 0
  group B  kappa_1 rows: B_ik[rho] on the t digits, C_ijk[rho] on the
                         g digits                                      = u_1
  group C  kappa_2 rows: D_ijk[rho] on the h digits                    = u_2
  f16: <z, z> (bpow_k bpow_k2 on the z digit pairs) - (mult b2pow_k)
       c_i c_j on the g digits                                         = 0
  f17: bpow_k sum_i c_i phi_i on the z digits - (mult b1pow_k) c_i c_j
       on the h digits                                                 = 0
  f18: (mult b2pow_k) a_ij on the g digits + b1pow_k on the h_ii digits
                                                                       = b

with mult 1 on the diagonal and 2 above it, and the base's aggregates
a_ij, phi_i, b (``protocol.canonical_aggregates``).  Family 0 (group A,
row 0) is the one F' family.  Here each family block is built straight
from the base CRS over the witness positions it touches, and contracted
with alpha one block in memory at a time (``commit.ring_stream``); the
folded instance is then proved and verified with this reference's own
phases.  Its verifier takes the contracted relation as a one-family
statement with alpha = 1, which gives the same aggregates exactly.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from . import commit, modmath, protocol, sampling, zq
from . import ntt as ntt_ops
from . import prover as ref_prover
from . import verifier as ref_verifier
from .crs import CRS
from .instance import CRS_SEED_MULT
from .keys import fold_in
from .modmath import mod_pos, sum_sq_u64, to_signed_i32
from .oracle import DOM_BPP, InteractiveOracle
from .params import LabradorParams, _ceil_log
from .prover import TAG_ALPHA, TAG_BETA, TAG_OMEGA, TAG_PSI
from .structs import State, Transcript
from .structs import bincode_chunks as transcript_bincode

FOLDED_CRS_XOR = 0xF01D
OPENING = ("z", "t", "g", "h")


# -- the recursive proof ----------------------------------------------------

@dataclass
class RecursiveProof:
    """The base transcript with z, t, g, h emptied, the folded instance's
    norm bound beta' and the folded transcript."""

    base: Transcript
    beta_new: int
    folded: Transcript


def without_opening(tr: Transcript) -> Transcript:
    return dataclasses.replace(tr, **{f: getattr(tr, f)[:0].clone()
                                      for f in OPENING})


def bincode_chunks(rp: RecursiveProof, q: int, fs: bool = False):
    """The base transcript's bincode (four empty vectors for its
    opening), beta' as a little-endian u64, the folded transcript's."""
    yield from transcript_bincode(rp.base, q, fs)
    yield int(rp.beta_new).to_bytes(8, "little")
    yield from transcript_bincode(rp.folded, q, fs)


# -- the folded instance's shape --------------------------------------------

@dataclass(frozen=True)
class Layout:
    """Where each digit of the opening lies in the new witness, flattened
    to (r' n') ring elements."""

    p: LabradorParams
    nz: int
    mu: int
    n_new: int
    r_new: int
    garbage: int
    k_new: int

    @property
    def n_tri(self) -> int:
        return self.p.r * (self.p.r + 1) // 2

    def z(self, k, l):
        return k * self.n_new + l

    def t(self, i, k, row):
        p = self.p
        return self.nz * self.n_new + (i * p.t_1 + k) * p.kappa + row

    def g(self, tri, k):
        p = self.p
        return self.nz * self.n_new + p.r * p.t_1 * p.kappa + tri * p.t_2 + k

    def h(self, tri, k):
        p = self.p
        return (self.nz * self.n_new + p.r * p.t_1 * p.kappa
                + self.n_tri * p.t_2 + tri * p.t_1 + k)


def make_layout(p: LabradorParams, mu: int) -> Layout:
    nz = _ceil_log(p.q, p.b)
    n_tri = p.r * (p.r + 1) // 2
    garbage = p.r * p.t_1 * p.kappa + n_tri * p.t_2 + n_tri * p.t_1
    if mu <= 0:
        mu = max(1, int(round(math.sqrt(garbage))))
    return Layout(p=p, nz=nz, mu=mu, n_new=max(p.n, -(-garbage // mu)),
                  r_new=nz + mu, garbage=garbage,
                  k_new=p.kappa + p.kappa_1 + p.kappa_2 + 3)


def folded_params(lay: Layout, kappa_new: int,
                  beta_new: int) -> LabradorParams:
    p = lay.p
    return LabradorParams(n=lay.n_new, r=lay.r_new, q=p.q, d=p.d,
                          k_count=lay.k_new, l_count=1,
                          kappa_override=kappa_new, exact_digits=True,
                          beta_override=beta_new)


def folded_crs(crs: CRS, params_new: LabradorParams) -> CRS:
    """The CLI's folded CRS seed, seed ^ 0xF01D, with the seed read back
    from the base CRS (its seed * CRS_SEED_MULT mod 2^64)."""
    base_seed = (int(crs.key[0]) << 32) | int(crs.key[1])
    seed = base_seed * pow(CRS_SEED_MULT, -1, 1 << 64) % (1 << 64)
    return CRS.create(params_new, seed ^ FOLDED_CRS_XOR)


def _tri_pairs(r: int) -> list:
    return [(i, j) for i in range(r) for j in range(i, r)]


def digit_witness(lay: Layout, proof: Transcript) -> torch.Tensor:
    """(r', n', d) exact signed digits of the opening at their positions."""
    p = lay.p
    dec = zq.decompose_balanced_big
    z_dig = dec(proof.z, p.b, lay.nz, p.q)                  # (nz, n, d)
    t_dig = dec(proof.t, p.b_1, p.t_1, p.q)                 # (t1, r, kap, d)
    g_dig = dec(proof.g, p.b_2, p.t_2, p.q)                 # (t2, r, r, d)
    h_dig = dec(proof.h, p.b_1, p.t_1, p.q)
    w = torch.zeros((lay.r_new * lay.n_new, p.d), dtype=torch.int64,
                    device=proof.u_1.device)
    for k in range(lay.nz):
        w[lay.z(k, 0):lay.z(k, p.n)] = z_dig[k]
    for i in range(p.r):
        for k in range(p.t_1):
            w[lay.t(i, k, 0):lay.t(i, k, p.kappa)] = t_dig[k, i]
    for tri, (i, j) in enumerate(_tri_pairs(p.r)):
        for k in range(p.t_2):
            w[lay.g(tri, k)] = g_dig[k, i, j]
        for k in range(p.t_1):
            w[lay.h(tri, k)] = h_dig[k, i, j]
    return w.reshape(lay.r_new, lay.n_new, p.d)


def witness_beta(w: torch.Tensor) -> int:
    return math.isqrt(2 * sum_sq_u64(w)) + 1


def beta_new_max(p: LabradorParams) -> int:
    return math.isqrt(2 * int(p.beta_prime)) + 1


# -- the folded relation, block by block ------------------------------------

def _tri_index(r: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    iu, ju = zip(*_tri_pairs(r))
    return (torch.tensor(iu, device=device), torch.tensor(ju, device=device))


@dataclass
class Block:
    """Rows ``rows`` of the relation over the witness positions ``cols``:
    phi (R, C, d) canonical."""

    rows: range
    cols: torch.Tensor
    phi: torch.Tensor


class FoldedRelation:
    """The folded statement, rebuilt from the base transcript's public
    fields and the base CRS."""

    def __init__(self, p: LabradorParams, state: State, proof: Transcript,
                 crs: CRS, lay: Layout):
        self.p, self.lay, self.crs = p, lay, crs
        q, dev = p.q, proof.u_1.device
        plan = ntt_ops.plan_for(p)
        self.dev = dev
        self.c = proof.c
        c_hat = ntt_ops.ntt_fwd(proof.c, plan)
        self.cc = ntt_ops.ntt_inv_modq(ntt_ops.eval_mul(
            c_hat[:, :, None, :], c_hat[:, None, :, :], plan), plan)
        self.a_fin, phi_fin, self.b_fin = protocol.canonical_aggregates(
            p, state, proof)
        self.cphi = ntt_ops.ntt_inv_modq(ntt_ops._mod_sum_p(ntt_ops.eval_mul(
            c_hat[:, :, None, :], ntt_ops.ntt_fwd(phi_fin, plan), plan),
            plan, axis=1), plan)                            # (n, d)
        self.bpow = [pow(p.b, k, q) for k in range(lay.nz)]
        self.b1pow = [pow(p.b_1, k, q) for k in range(p.t_1)]
        self.b2pow = [pow(p.b_2, k, q) for k in range(p.t_2)]
        b_k = torch.zeros((lay.k_new, p.d), dtype=torch.int64, device=dev)
        b_k[p.kappa:p.kappa + p.kappa_1] = proof.u_1
        r2 = p.kappa + p.kappa_1
        b_k[r2:r2 + p.kappa_2] = proof.u_2
        b_k[r2 + p.kappa_2 + 2] = self.b_fin
        self.b_k = b_k
        row0 = self.block_a(range(0, 1))
        flat = torch.zeros((lay.r_new * lay.n_new, p.d), dtype=torch.int64,
                           device=dev)
        flat[row0.cols] = row0.phi[0]
        self.phi_prime_k = flat.reshape(1, lay.r_new, lay.n_new, p.d)
        self.a_prime_k = torch.zeros((1, lay.r_new, lay.r_new, p.d),
                                     dtype=torch.int64, device=dev)
        self.b_prime_k = b_k[0:1, 0]

    def _cols(self, idx: list) -> torch.Tensor:
        return torch.tensor(idx, dtype=torch.int64, device=self.dev)

    def block_a(self, rows: range) -> Block:
        """Group A: A z == sum_i c_i t_i over the z and t digits."""
        p, lay, q = self.p, self.lay, self.p.q
        nd = p.n * p.d
        a = self.crs.expand(rows.start * nd, (len(rows), p.n, p.d),
                            (nd, p.d, 1), self.dev)
        z_part = torch.stack([modmath.mulmod(a, self.bpow[k], q)
                              for k in range(lay.nz)], dim=1)
        # row rho holds -c_i b1pow_k at the digit t_i^(k)[rho] alone
        t_part = torch.zeros((len(rows), p.r, p.t_1, p.kappa, p.d),
                             dtype=torch.int64, device=self.dev)
        neg_c = mod_pos(-self.c, q)
        vals = torch.stack([modmath.mulmod(neg_c, w, q)
                            for w in self.b1pow], dim=1)
        e = torch.arange(len(rows), device=self.dev)
        rho = torch.tensor(list(rows), device=self.dev)
        t_part[e, :, :, rho] = vals[None].expand(len(rows), -1, -1, -1)
        cols = [lay.z(k, l) for k in range(lay.nz) for l in range(p.n)] + \
            [lay.t(i, k, col) for i in range(p.r) for k in range(p.t_1)
             for col in range(p.kappa)]
        phi = torch.cat([z_part.reshape(len(rows), -1, p.d),
                         t_part.reshape(len(rows), -1, p.d)], dim=1)
        return Block(rows, self._cols(cols), phi)

    def block_b(self) -> Block:
        """Group B: u1 == sum B_ik t_i^(k) + sum C_ijk g_ij^(k)."""
        p, lay, crs = self.p, self.lay, self.crs
        assert p.kappa_1 == p.kappa_2, "C has kappa_2 rows in u1's sum"
        b = crs.expand(crs._off_b, (p.kappa_1, p.r * p.t_1, p.kappa, p.d),
                       (p.kappa * p.d, p.kappa_1 * p.kappa, p.d, 1), self.dev)
        c = crs.expand(crs._off_c, (p.kappa_2, lay.n_tri, p.t_2, p.d),
                       (p.d, p.t_1 * p.kappa_2 * p.d, p.kappa_2 * p.d, 1),
                       self.dev)
        cols = [lay.t(i, k, col) for i in range(p.r) for k in range(p.t_1)
                for col in range(p.kappa)] + \
            [lay.g(tri, k) for tri in range(lay.n_tri) for k in range(p.t_2)]
        phi = torch.cat([b.reshape(p.kappa_1, -1, p.d),
                         c.reshape(p.kappa_2, -1, p.d)], dim=1)
        return Block(range(p.kappa, p.kappa + p.kappa_1), self._cols(cols),
                     phi)

    def block_c(self) -> Block:
        """Group C: u2 == sum D_ijk h_ij^(k)."""
        p, lay, crs = self.p, self.lay, self.crs
        dmat = crs.expand(crs._off_d, (p.kappa_2, lay.n_tri, p.t_1, p.d),
                          (p.d, p.t_1 * p.kappa_2 * p.d, p.kappa_2 * p.d, 1),
                          self.dev)
        cols = [lay.h(tri, k) for tri in range(lay.n_tri)
                for k in range(p.t_1)]
        r2 = p.kappa + p.kappa_1
        return Block(range(r2, r2 + p.kappa_2), self._cols(cols),
                     dmat.reshape(p.kappa_2, -1, p.d))

    def _tri_terms(self, x: torch.Tensor, pows: list, pos) -> tuple:
        """(cols, values (n_tri * len(pows), d)): (mult pows_k) x_ij at
        pos(tri, k), mult 1 on the diagonal and 2 above it."""
        q = self.p.q
        pairs = _tri_pairs(self.p.r)
        iu, ju = _tri_index(self.p.r, self.dev)
        w = torch.tensor([[(1 if i == j else 2) * pw % q for pw in pows]
                          for i, j in pairs], dtype=torch.int64,
                         device=self.dev)
        vals = modmath.mulmod(x[iu, ju][:, None, :], w[:, :, None], q)
        cols = [pos(tri, k) for tri in range(len(pairs))
                for k in range(len(pows))]
        return cols, vals.reshape(-1, self.p.d)

    def block_f16(self) -> Block:
        """<z, z> == sum_ij c_i c_j g_ij, linear part."""
        p, lay, q = self.p, self.lay, self.p.q
        cols, vals = self._tri_terms(mod_pos(-self.cc, q), self.b2pow, lay.g)
        f16 = p.kappa + p.kappa_1 + p.kappa_2
        return Block(range(f16, f16 + 1), self._cols(cols), vals[None])

    def block_f17(self) -> Block:
        """sum_i <phi_i, z> c_i == sum_ij c_i c_j h_ij."""
        p, lay, q = self.p, self.lay, self.p.q
        cols = [lay.z(k, l) for k in range(lay.nz) for l in range(p.n)]
        vals = torch.cat([modmath.mulmod(self.cphi, w, q) for w in self.bpow])
        hc, hv = self._tri_terms(mod_pos(-self.cc, q), self.b1pow, lay.h)
        f17 = p.kappa + p.kappa_1 + p.kappa_2 + 1
        return Block(range(f17, f17 + 1), self._cols(cols + hc),
                     torch.cat([vals, hv])[None])

    def block_f18(self) -> Block:
        """sum_ij a_ij g_ij + sum_i h_ii == b."""
        p, lay, q = self.p, self.lay, self.p.q
        cols, vals = self._tri_terms(self.a_fin, self.b2pow, lay.g)
        diag = [tri for tri, (i, j) in enumerate(_tri_pairs(p.r)) if i == j]
        consts = torch.zeros((len(diag), p.t_1, p.d), dtype=torch.int64,
                             device=self.dev)
        consts[:, :, 0] = torch.tensor(self.b1pow, device=self.dev)
        cols += [lay.h(tri, k) for tri in diag for k in range(p.t_1)]
        f18 = p.kappa + p.kappa_1 + p.kappa_2 + 2
        return Block(range(f18, f18 + 1), self._cols(cols),
                     torch.cat([vals, consts.reshape(-1, p.d)])[None])

    def blocks(self):
        """Every family block in turn (one in memory at a time)."""
        p = self.p
        yield self.block_a(range(0, p.kappa))
        yield self.block_b()
        yield self.block_c()
        yield self.block_f16()
        yield self.block_f17()
        yield self.block_f18()

    def _contract(self, mat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """sum_rho w_rho (*) mat[rho] mod q: mat (R, C, d) -> (C, d)."""
        return commit.ring_stream(
            lambda l0, l1: mat[l0:l1].transpose(0, 1), w[None],
            mat.shape[1], self.p.q)[0]

    def phi_alpha(self, alpha: torch.Tensor) -> torch.Tensor:
        """sum_k alpha_k phi_k -> (r', n', d) mod q."""
        p, lay = self.p, self.lay
        flat = torch.zeros((lay.r_new * lay.n_new, p.d), dtype=torch.int64,
                           device=self.dev)
        for blk in self.blocks():
            part = self._contract(blk.phi, alpha[blk.rows.start:
                                                 blk.rows.stop])
            flat[blk.cols] = zq.add(flat[blk.cols], part, p.q)
            del blk, part
        return flat.reshape(lay.r_new, lay.n_new, p.d)

    def a_alpha(self, alpha: torch.Tensor) -> torch.Tensor:
        """sum_k alpha_k a_k -> (r', r', d): f16's constant entries
        bpow_k bpow_k2 on the z digit pairs, the other families none."""
        p, lay, q = self.p, self.lay, self.p.q
        a16 = torch.zeros((1, lay.nz * lay.nz, p.d), dtype=torch.int64,
                          device=self.dev)
        for k in range(lay.nz):
            for k2 in range(lay.nz):
                a16[0, k * lay.nz + k2, 0] = self.bpow[k] * self.bpow[k2] % q
        f16 = p.kappa + p.kappa_1 + p.kappa_2
        part = self._contract(a16, alpha[f16:f16 + 1])
        out = torch.zeros((lay.r_new, lay.r_new, p.d), dtype=torch.int64,
                          device=self.dev)
        out[:lay.nz, :lay.nz] = part.reshape(lay.nz, lay.nz, p.d)
        return out

    def b_alpha(self, alpha: torch.Tensor) -> torch.Tensor:
        """sum_k alpha_k b_k -> (d,)."""
        return self._contract(self.b_k[:, None], alpha)[0]


# -- prover and verifier ----------------------------------------------------

def _aggregate_h_folded(p: LabradorParams, witness: torch.Tensor,
                        rel: FoldedRelation, oracle, ost, g: torch.Tensor,
                        ph2a: dict):
    """The reference prover's steps 5-7 on the folded relation: phi =
    ``rel.phi_alpha(alpha)`` + sum_k beta_k phi''_k."""
    dev = witness.device
    plan = ntt_ops.plan_for(p)
    s_hat = ntt_ops.ntt_fwd(witness, plan)
    pi, projection = ph2a["pi"], ph2a["projection"]
    ub = p.upper_bound
    psi = torch.stack([sampling.sample_psi(
        oracle.challenge_key(ost, TAG_PSI, i), p, dev) for i in range(ub)])
    omega = torch.stack([sampling.sample_omega(
        oracle.challenge_key(ost, TAG_OMEGA, i), p, dev) for i in range(ub)])
    a_pp = protocol.aggregate_a_pp(rel.a_prime_k, psi, p.q)
    phi_pp = protocol.aggregate_phi_pp(rel.phi_prime_k, psi, omega, pi, p)
    a_pp_hat = ntt_ops.ntt_fwd(a_pp, plan)
    phi_pp_hat = ntt_ops.ntt_fwd(phi_pp, plan)
    b_pp = protocol.b_pp_from_witness(a_pp_hat, phi_pp_hat, s_hat,
                                      ntt_ops.ntt_fwd(g, plan), plan)
    expected = protocol.b_pp_expected_const(omega, psi, projection,
                                            rel.b_prime_k, p.q)
    b_pp_ok = zq.all_eq(b_pp[:, 0], expected)
    ost = oracle.absorb(ost, DOM_BPP, [b_pp])
    alpha = sampling.sample_alpha(oracle.challenge_key(ost, TAG_ALPHA), p,
                                  dev)
    beta = sampling.sample_beta(oracle.challenge_key(ost, TAG_BETA), p, dev)
    beta_hat = ntt_ops.ntt_fwd(beta, plan)
    phi_fin = zq.add(rel.phi_alpha(alpha), ntt_ops.ntt_inv_modq(
        protocol.phi_weighted_hat(beta_hat, phi_pp_hat, plan), plan), p.q)
    m = ntt_ops.ntt_inv_modq(ntt_ops.eval_matmul(
        ntt_ops.ntt_fwd(phi_fin, plan), torch.swapaxes(s_hat, -3, -2),
        plan), plan)
    h = modmath.mulmod(mod_pos(m + torch.swapaxes(m, 0, 1), p.q), p.inv2, p.q)
    return ost, dict(psi=psi, omega=omega, b_prime_prime=b_pp, alpha=alpha,
                     beta=beta, h=h,
                     b_pp_ok=torch.tensor(b_pp_ok, device=dev))


def prove_folded(p: LabradorParams, witness: torch.Tensor,
                 rel: FoldedRelation, crs: CRS, verifier_key) -> Transcript:
    """The interactive prover's phases 1, 2a and 3 as they are; phase 2b
    with the folded relation's blocks."""
    oracle = InteractiveOracle(vkey=verifier_key)
    ost = oracle.init()
    ost, ph1 = ref_prover.prove_phase1(p, witness, rel, crs, oracle, ost)
    ost, ph2a = ref_prover.prove_phase2a(p, witness, rel, crs, oracle, ost,
                                         ph1)
    ost, agg = _aggregate_h_folded(p, witness, rel, oracle, ost, ph1["g"],
                                   ph2a)
    ph2 = {**ph2a, **agg, "u_2": protocol.u2_from_digits(
        crs, protocol.decompose_h(agg["h"], p), p)}
    ph3 = ref_prover.prove_phase3(p, witness, oracle, ost, ph2)
    return Transcript(t=ph1["t"], g=ph1["g"], u_1=ph1["u_1"], **ph2, **ph3)


def verify_folded(p: LabradorParams, rel: FoldedRelation,
                  proof: Transcript, crs: CRS) -> dict:
    """The reference's ``verify_report`` on the relation contracted with
    the proof's alpha, as one family with alpha = 1."""
    one = torch.zeros((1, p.d), dtype=torch.int64, device=rel.dev)
    one[0, 0] = 1
    state = State(a_k=rel.a_alpha(proof.alpha)[None],
                  phi_k=rel.phi_alpha(proof.alpha)[None],
                  b_k=rel.b_alpha(proof.alpha)[None],
                  a_prime_k=rel.a_prime_k, phi_prime_k=rel.phi_prime_k,
                  b_prime_k=rel.b_prime_k)
    return ref_verifier.verify_report(p, state,
                                      dataclasses.replace(proof, alpha=one),
                                      crs)


def prove_recursive(params: LabradorParams, witness: torch.Tensor,
                    state: State, crs: CRS, verifier_key, mu: int,
                    kappa_new: int) -> RecursiveProof:
    base = ref_prover.prove(params, witness, state, crs, verifier_key)
    lay = make_layout(params, mu)
    w2 = digit_witness(lay, base)
    p2 = folded_params(lay, kappa_new, witness_beta(w2))
    rel = FoldedRelation(params, state, base, crs, lay)
    folded = prove_folded(p2, w2, rel, folded_crs(crs, p2),
                          fold_in(verifier_key, 1))
    return RecursiveProof(without_opening(base), p2.beta_override, folded)


def _shapes(p: LabradorParams) -> dict:
    ub, d = p.upper_bound, p.d
    return {"u_1": (p.kappa_1, d), "pi": (p.r, 256, p.n * d),
            "projection": (256,), "psi": (ub, p.l_count),
            "omega": (ub, 256), "b_prime_prime": (ub, d),
            "alpha": (p.k_count, d), "beta": (ub, d), "u_2": (p.kappa_2, d),
            "c": (p.r, d), "z": (p.n, d), "t": (p.r, p.kappa, d),
            "g": (p.r, p.r, d), "h": (p.r, p.r, d)}


def _shapes_ok(p: LabradorParams, tr: Transcript, skip=()) -> bool:
    return all(tuple(getattr(tr, k).shape) == v
               for k, v in _shapes(p).items() if k not in skip)


def _projection_ok(p: LabradorParams, projection: torch.Tensor) -> bool:
    """verification.rs:568-579 on the centred int32 words, each entry
    within sqrt(128) beta first."""
    c = to_signed_i32(zq.to_signed_small(projection, p.q))
    bound = 128 * p.beta_bound * p.beta_bound
    entry_max = min(math.isqrt(bound), 2**31 - 1)
    mag = torch.where(c == -(1 << 31), c, torch.abs(c))
    return bool(torch.all(mag <= entry_max)) and sum_sq_u64(c) <= bound


def verify_recursive(params: LabradorParams, state: State,
                     rp: RecursiveProof, crs: CRS, mu: int,
                     kappa_new: int) -> dict:
    p, base = params, rp.base
    out = {"base.shapes": _shapes_ok(p, base, skip=OPENING)}
    out["base.c21_b_pp_const"] = out["base.shapes"] and zq.all_eq(
        base.b_prime_prime[:, 0], protocol.b_pp_expected_const(
            base.omega, base.psi, base.projection,
            state.b_prime_k[:p.l_count], p.q))
    out["base.jl_norm"] = out["base.shapes"] \
        and _projection_ok(p, base.projection)
    out["base_public"] = all(out.values())
    out["beta_new_bound"] = 1 <= int(rp.beta_new) <= beta_new_max(p)
    out["fold_statement"] = out["folded"] = False
    if out["beta_new_bound"] and out["base.shapes"]:
        lay = make_layout(p, mu)
        p2 = folded_params(lay, kappa_new, int(rp.beta_new))
        rel = FoldedRelation(p, state, base, crs, lay)
        out["fold_statement"] = _shapes_ok(p2, rp.folded)
    if out["fold_statement"]:
        rep = verify_folded(p2, rel, rp.folded, folded_crs(crs, p2))
        out.update({"folded." + k: v for k, v in rep.items()})
        out["folded"] = rep["all_with_bpp"]
    out["all"] = all(out[k] for k in ("base_public", "beta_new_bound",
                                      "fold_statement", "folded"))
    return out

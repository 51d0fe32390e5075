"""Reference-simulator: the Rust reference's exact prove/verify semantics
in slow, independent numpy.

The port's copy of ``labrador_tpu/utils/refsim.py``: the same algorithm,
taking the port's objects (torch tensors are read through ``_np``; the
CRS tiles are fetched on the CRS's own device, the table's for a
``MaterializedCRS``, the CPU for a Threefry ``CRS``).  It imports only
numpy and nothing of the port: it is an oracle for the tests, the
``chip_smoke.py`` ChaCha phase and ``benchmarks/proof_size_parity.py``,
and nothing on the prove path calls it.

``ref_prove`` transliterates ``Prover::proof_gen``
(``proofgen.rs:30-427``) step by step and ``ref_verify``
transliterates ``Verifier::verify`` (``verification.rs:25-438``), over plain
int64 coefficient arrays — schoolbook negacyclic products (no NTT, no CRT,
no MXU), the quirky ``centered_rep`` digit loop (``util.rs:377-442``), raw-
residue JL coefficients (``Zq::lift_inv``, ``algebraic.rs:47-53``), and the
reference's f64 Check-14 accumulation (``verification.rs:231-267``).

The one thing it does NOT reproduce is the reference's *verifier challenge
RNG*: the reference draws challenges from an unseeded ``rand::thread_rng``
(``verification.rs:441-513``), so no implementation anywhere can replay
those draws.  The challenges (pi, psi, omega, alpha, beta, c) are therefore
*inputs* here — extracted from the transcript under test — and everything
the protocol derives from them (t, g, u1, p, b'', h, u2, z, all 14 checks)
is recomputed independently.  CRS coefficients come from the caller too:
pass a ``crs.MaterializedCRS`` created with ``create_chacha`` and the
values are bit-identical to the reference's lazy oracle
(structs.rs:147-171).

Exactness domain: all arithmetic is int64 with reductions placed exactly
where the reference reduces; the largest intermediate is a length-kappa
ring inner product, |sum| <= kappa * d * q^2, asserted < 2^63.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ref_prove", "ref_verify", "extract_challenges"]


def _np(x) -> np.ndarray:
    """A torch tensor (on any device) or an array as numpy int64."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.int64)


# ---------------------------------------------------------------------------
# Ring primitives (schoolbook, independent of ops/ntt.py)
# ---------------------------------------------------------------------------

def _circ(b: np.ndarray) -> np.ndarray:
    """Negacyclic circulant of b (..., d): out[..., i, k] with
    (a ringmul b)[k] = sum_i a[i] * out[..., i, k]  — the schoolbook product
    of ``Rq::multiply`` with reduction X^d = -1 (algebraic.rs:352-404)."""
    d = b.shape[-1]
    i = np.arange(d)[:, None]
    k = np.arange(d)[None, :]
    sign = np.where(k >= i, 1, -1)
    return b[..., (k - i) % d] * sign


def _mul(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Ring product of (..., d) coefficient arrays mod q."""
    return np.einsum("...i,...ik->...k", a, _circ(b)) % q


def _inner(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """<a, b> over (..., m, d) vectors of ring elements mod q
    (``polynomial_vec_inner_product``, util.rs:496-509)."""
    m = a.shape[-2]
    d = a.shape[-1]
    assert m * d * (q - 1) ** 2 < 2**63, "int64 exactness bound exceeded"
    return np.einsum("...mi,...mik->...k", a, _circ(b)) % q


def _inner_mat(M: np.ndarray, v: np.ndarray, q: int) -> np.ndarray:
    """<M[K], v> for M (K, m, d) against a shared v (m, d): the circulant
    sits on the small v side so memory stays O(m d^2), not O(K m d^2).
    Ring products commute, so this equals row-wise ``_inner``."""
    K, m, d = M.shape
    assert m * d * (q - 1) ** 2 < 2**63, "int64 exactness bound exceeded"
    return np.einsum("Kmi,mik->Kk", M, _circ(v)) % q


def _sigma_inv(a: np.ndarray, q: int) -> np.ndarray:
    """Conjugation automorphism X^n -> -X^(d-n) (util.rs:118-137)."""
    d = a.shape[-1]
    out = np.zeros_like(a)
    out[..., 0] = a[..., 0]
    out[..., 1:] = (-a[..., :0:-1]) % q
    return out


def _decompose(vals: np.ndarray, base: int, ndig: int) -> np.ndarray:
    """The reference's quirky base-b digit loop (util.rs:389-442) on raw
    residues: d0 = c % b; digit = (b - d0) % b if d0 > b//2 else d0
    (``centered_rep`` keeps it POSITIVE, util.rs:377-387);
    c = (c - digit) / b (truncating).  Digits beyond ndig are dropped,
    missing digits are zero.  Returns (ndig, *vals.shape)."""
    c = _np(vals).copy()
    digs = np.zeros((ndig,) + c.shape, np.int64)
    for k in range(ndig):
        d0 = c % base
        r = np.where(d0 > base // 2, (base - d0) % base, d0)
        digs[k] = r
        c = (c - r) // base  # c - r >= 0 always, so floor == truncation
    return digs


def _upper_bound(params) -> int:
    # min(K, ceil(128 / log2 q)) — proofgen.rs:189 / verification.rs:28
    return min(params.k_count,
               math.ceil(128.0 / math.log2(float(params.q))))


# ---------------------------------------------------------------------------
# Challenge extraction
# ---------------------------------------------------------------------------

def extract_challenges(proof) -> dict:
    """Pull the verifier randomness out of a Transcript so ref_prove can
    replay the deterministic protocol on identical challenges."""
    g = _np
    return dict(pi=g(proof.pi), psi=g(proof.psi), omega=g(proof.omega),
                alpha=g(proof.alpha), beta=g(proof.beta), c=g(proof.c))


def _crs_np(crs) -> dict:
    """Materialize the CRS tiles the protocol reads as numpy int64,
    fetched on the CRS's device (the table's, else the CPU)."""
    p = crs.params
    dev = crs.coeffs.device if hasattr(crs, "coeffs") else "cpu"
    return dict(
        a=_np(crs.a_rows(device=dev)),                         # (kappa, n, d)
        b=np.stack([np.stack([_np(crs.b_rows(i, k, device=dev))
                              for k in range(p.t_1)])
                    for i in range(p.r)]),     # (r, t_1, kappa_1, kappa, d)
        c={(i, j, k): _np(crs.c_vec(i, j, k, device=dev))
           for i in range(p.r) for j in range(i, p.r)
           for k in range(p.t_2)},                             # (kappa_2, d)
        d={(i, j, k): _np(crs.d_vec(i, j, k, device=dev))
           for i in range(p.r) for j in range(i, p.r)
           for k in range(p.t_1)},
    )


# ---------------------------------------------------------------------------
# Prover (proofgen.rs:30-427)
# ---------------------------------------------------------------------------

def ref_prove(params, witness, state, crs, chal: dict) -> dict:
    """Recompute every transcript field the reference prover derives,
    given the witness, state, CRS, and the verifier challenges.

    witness: (r, n, d) residues in [0, q) — the reference's Array2<Rq>
    column-major layout (column i = s_i, proofgen.rs:45).  Returns a dict
    with keys matching structs.Transcript field names.
    """
    p = params
    q = p.q
    assert p.l_count == 1 and p.k_count == 1, \
        "refsim replays the reference's hardcoded K=1, L=1 protocol path " \
        "(proofgen.rs:228,234 index family 0 directly)"
    s = _np(witness)                            # (r, n, d)
    r_, n, d = s.shape
    cr = _crs_np(crs)
    ub = _upper_bound(p)

    # step 1: t_i = A s_i  (proofgen.rs:41-49) — per-row inner products
    # t[i, kap] = <A_row(kap), s_i>
    t = np.stack([_inner_mat(cr["a"], s[i], q)
                  for i in range(r_)])          # (r, kappa, d)

    # step 2: g_ij = <s_i, s_j>  (proofgen.rs:59-70)
    g = np.stack([np.stack([_inner(s[i], s[j], q) for j in range(r_)])
                  for i in range(r_)])          # (r, r, d)

    # step 3: u1 (proofgen.rs:100-153)
    u_1 = np.zeros((p.kappa_1, d), np.int64)
    for i in range(r_):
        t_dig = _decompose(t[i], p.b_1, p.t_1)  # (t_1, kappa, d)
        for k in range(p.t_1):
            # <B_ik row, t_i^(k)> for each of the kappa_1 rows
            u_1 = (u_1 + _inner_mat(cr["b"][i, k], t_dig[k], q)) % q
    for i in range(r_):
        for j in range(i, r_):
            g_dig = _decompose(g[i, j], p.b_2, p.t_2)     # (t_2, d)
            for k in range(p.t_2):
                u_1 = (u_1 + _mul(np.broadcast_to(g_dig[k],
                                                  cr["c"][(i, j, k)].shape),
                                  cr["c"][(i, j, k)], q)) % q

    # step 4: JL projection p = sum_i Pi_i @ coeffs(s_i)  (proofgen.rs:429-456)
    # Zq::lift_inv = RAW residues (algebraic.rs:47-53); exactness relies on
    # witness coefficients being small (the norm-bounded witness of
    # proofgen.rs:460-518 — assert, don't assume).
    assert int(s.max()) < q // 2, "reference witnesses are small nonneg"
    s_flat = s.reshape(r_, n * d)
    proj_int = np.einsum("rjk,rk->j", chal["pi"], s_flat)   # (256,)
    projection = proj_int % q                               # Zq::lift

    # step 5: first aggregation (proofgen.rs:189-289)
    b_pp = np.zeros((ub, d), np.int64)
    phi_pp = np.zeros((ub, r_, n, d), np.int64)
    pi_lift = chal["pi"] % q                      # (r, 256, n*d) residues
    for k in range(ub):
        psi_sum = int(chal["psi"][k].sum() % q)   # multiply_poly_ints sums
        # a''_ij = a'_ij * (sum_l psi_l)  (util.rs:148-155 quirk; == the
        # verifier's sum_l psi_l a'_l at L=1)
        a_pp = _np(state.a_prime_k)[0] * psi_sum % q
        for i in range(r_):
            lhs = _np(state.phi_prime_k)[0, i] * psi_sum % q
            # rhs: sum_j omega[0][j] * sigma_inv(pi_i^(j))  — NOTE the
            # reference indexes omega[0] for every k (proofgen.rs:250);
            # indistinguishable from omega[k] at ub == 1 (the only regime
            # the reference can reach with K = 1)
            pi_polys = pi_lift[i].reshape(256, n, d)
            conj = _sigma_inv(pi_polys, q)                  # (256, n, d)
            rhs = np.einsum("j,jJk->Jk", chal["omega"][0] % q,
                            conj) % q                       # (n, d)
            phi_pp[k, i] = (lhs + rhs) % q
        acc = np.zeros(d, np.int64)
        for i in range(r_):
            for j in range(r_):
                acc = (acc + _mul(a_pp[i, j], _inner(s[i], s[j], q), q)) % q
        for i in range(r_):
            acc = (acc + _inner(phi_pp[k, i], s[i], q)) % q
        b_pp[k] = acc

    # step 6: phi_final (proofgen.rs:295-314)
    phi_fin = np.zeros((r_, n, d), np.int64)
    for i in range(r_):
        acc = np.zeros((n, d), np.int64)
        for k in range(p.k_count):
            acc = (acc + _mul(np.broadcast_to(chal["alpha"][k] % q, (n, d)),
                              _np(state.phi_k)[k, i], q)) % q
        for k in range(ub):
            acc = (acc + _mul(np.broadcast_to(chal["beta"][k] % q, (n, d)),
                              phi_pp[k, i], q)) % q
        phi_fin[i] = acc

    # step 7: h = 2^{-1} (<phi_i, s_j> + <phi_j, s_i>)  (proofgen.rs:320-358)
    # MOD_SUSPENSION + Fermat inverse == one modular multiply by inv2
    inv2 = pow(2, q - 2, q)
    h = np.zeros((r_, r_, d), np.int64)
    for i in range(r_):
        for j in range(r_):
            tot = (_inner(phi_fin[i], s[j], q) + _inner(phi_fin[j], s[i], q))
            h[i, j] = tot * inv2 % q

    # step 8: u2 (proofgen.rs:364-378)
    u_2 = np.zeros((p.kappa_2, d), np.int64)
    for i in range(r_):
        for j in range(i, r_):
            h_dig = _decompose(h[i, j], p.b_1, p.t_1)
            for k in range(p.t_1):
                u_2 = (u_2 + _mul(np.broadcast_to(h_dig[k],
                                                  cr["d"][(i, j, k)].shape),
                                  cr["d"][(i, j, k)], q)) % q

    # step 9: z = sum_i c_i s_i  (proofgen.rs:380-399)
    z = np.zeros((n, d), np.int64)
    for i in range(r_):
        z = (z + _mul(np.broadcast_to(chal["c"][i] % q, (n, d)), s[i], q)) % q

    return dict(t=t, g=g, u_1=u_1, projection=projection,
                b_prime_prime=b_pp, h=h, u_2=u_2, z=z)


# ---------------------------------------------------------------------------
# Verifier (verification.rs:25-438)
# ---------------------------------------------------------------------------

def ref_verify(params, state, proof, crs) -> dict:
    """The reference's 14-check acceptance predicate, per-check report.
    Check 14 uses the reference's f64 accumulation and its squared
    BETA_PRIME convention (verification.rs:231-267, constants.rs:253)."""
    p = params
    q = p.q
    d = p.d
    r_ = p.r
    cr = _crs_np(crs)
    ub = _upper_bound(p)
    arr = _np
    g_mat, h_mat = arr(proof.g), arr(proof.h)
    z, t, c = arr(proof.z), arr(proof.t), arr(proof.c) % q
    alpha, beta = arr(proof.alpha) % q, arr(proof.beta) % q
    psi, omega = arr(proof.psi) % q, arr(proof.omega) % q
    pi_lift = arr(proof.pi) % q

    checks = {}

    # lines 3-4: a'', phi''
    a_prime = arr(state.a_prime_k)        # (L, r, r, d)
    phi_prime = arr(state.phi_prime_k)    # (L, r, n, d)
    n = phi_prime.shape[2]
    a_pp = np.einsum("kl,lijd->kijd", psi[:, :p.l_count],
                     a_prime) % q                     # (ub, r, r, d)
    conj = _sigma_inv(pi_lift.reshape(r_, 256, n, d), q)
    phi_pp = (np.einsum("kl,liJd->kiJd", psi[:, :p.l_count], phi_prime)
              + np.einsum("kj,ijJd->kiJd", omega, conj)) % q  # (ub, r, n, d)

    # lines 5-7: canonical a, phi, b
    a_canon = np.zeros((r_, r_, d), np.int64)
    for k in range(p.k_count):
        ca = _circ(arr(state.a_k)[k])                 # (r, r, d, d)
        a_canon = (a_canon + np.einsum("i,...ik->...k", alpha[k], ca)) % q
    for k in range(ub):
        a_canon = (a_canon + np.einsum(
            "i,...ik->...k", beta[k], _circ(a_pp[k]))) % q
    phi_canon = np.zeros((r_, n, d), np.int64)
    for k in range(p.k_count):
        phi_canon = (phi_canon + np.einsum(
            "i,...ik->...k", alpha[k], _circ(arr(state.phi_k)[k]))) % q
    for k in range(ub):
        phi_canon = (phi_canon + np.einsum(
            "i,...ik->...k", beta[k], _circ(phi_pp[k]))) % q
    b_canon = np.zeros(d, np.int64)
    for k in range(p.k_count):
        b_canon = (b_canon + _mul(alpha[k], arr(state.b_k)[k], q)) % q
    for k in range(ub):
        b_canon = (b_canon + _mul(beta[k], arr(proof.b_prime_prime)[k],
                                  q)) % q

    # checks 8-9: symmetry
    checks["c08_g_symmetric"] = bool((g_mat == g_mat.swapaxes(0, 1)).all())
    checks["c09_h_symmetric"] = bool((h_mat == h_mat.swapaxes(0, 1)).all())

    # lines 10-13: digit decompositions
    z_dig = _decompose(z, p.b, 2)                       # (2, n, d)
    t_dig = _decompose(t, p.b_1, p.t_1)                 # (t_1, r, kappa, d)
    g_dig = _decompose(g_mat, p.b_2, p.t_2)             # (t_2, r, r, d)
    h_dig = _decompose(h_mat, p.b_1, p.t_1)             # (t_1, r, r, d)

    # check 14: f64 accumulation over raw residues, vs squared beta'
    # (the reference's known precision bug at large q is faithful here)
    sum14 = (float((z_dig.astype(np.float64) ** 2).sum())
             + float((t_dig.astype(np.float64) ** 2).sum())
             + float((g_dig.astype(np.float64) ** 2).sum())
             + float((h_dig.astype(np.float64) ** 2).sum()))
    checks["c14_norm_bound"] = bool(sum14 <= float(p.beta_prime))

    # check 15: A z == sum_i c_i t_i
    lhs15 = _inner_mat(cr["a"], z, q)
    rhs15 = np.zeros((p.kappa, d), np.int64)
    for i in range(r_):
        rhs15 = (rhs15 + _mul(np.broadcast_to(c[i], t[i].shape), t[i],
                              q)) % q
    checks["c15_az_vs_ct"] = bool((lhs15 == rhs15).all())

    # check 16: <z, z> == sum_ij g_ij c_i c_j
    lhs16 = _inner(z, z, q)
    rhs16 = np.zeros(d, np.int64)
    for i in range(r_):
        for j in range(r_):
            rhs16 = (rhs16 + _mul(_mul(g_mat[i, j], c[i], q), c[j], q)) % q
    checks["c16_zz_vs_gcc"] = bool((lhs16 == rhs16).all())

    # check 17: sum_i <phi_i, z> c_i == sum_ij h_ij c_i c_j
    lhs17 = np.zeros(d, np.int64)
    for i in range(r_):
        lhs17 = (lhs17 + _mul(_inner(phi_canon[i], z, q), c[i], q)) % q
    rhs17 = np.zeros(d, np.int64)
    for i in range(r_):
        for j in range(r_):
            rhs17 = (rhs17 + _mul(_mul(h_mat[i, j], c[i], q), c[j], q)) % q
    checks["c17_phiz_vs_hcc"] = bool((lhs17 == rhs17).all())

    # check 18: sum_ij a_ij g_ij + sum_i h_ii == b
    s1 = np.zeros(d, np.int64)
    for i in range(r_):
        for j in range(r_):
            s1 = (s1 + _mul(a_canon[i, j], g_mat[i, j], q)) % q
    s2 = h_mat[np.arange(r_), np.arange(r_)].sum(axis=0) % q
    checks["c18_agg_relation"] = bool(((s1 + s2 - b_canon) % q == 0).all())

    # check 19: recompute u1 from t/g digits
    u1_cand = np.zeros((p.kappa_1, d), np.int64)
    for i in range(r_):
        for k in range(p.t_1):
            u1_cand = (u1_cand + _inner_mat(cr["b"][i, k], t_dig[k, i],
                                            q)) % q
    for i in range(r_):
        for j in range(i, r_):
            for k in range(p.t_2):
                u1_cand = (u1_cand + _mul(
                    np.broadcast_to(g_dig[k, i, j], cr["c"][(i, j, k)].shape),
                    cr["c"][(i, j, k)], q)) % q
    checks["c19_u1"] = bool((u1_cand == arr(proof.u_1)).all())

    # check 20: recompute u2 from h digits
    u2_cand = np.zeros((p.kappa_2, d), np.int64)
    for i in range(r_):
        for j in range(i, r_):
            for k in range(p.t_1):
                u2_cand = (u2_cand + _mul(
                    np.broadcast_to(h_dig[k, i, j], cr["d"][(i, j, k)].shape),
                    cr["d"][(i, j, k)], q)) % q
    checks["c20_u2"] = bool((u2_cand == arr(proof.u_2)).all())

    checks["all"] = all(checks.values())
    return checks

"""Recursive proof composition (BASELINE.json config 5 structure):
fold a verified base proof into a new principal relation, check the new
witness satisfies it exactly, and run prove+verify on the folded instance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from labrador_tpu.params import LabradorParams
from labrador_tpu import sampling, structs, prover, verifier, recursion
from labrador_tpu.crs import CRS

# small base instance with a realistic (constant) commitment rank so the
# folded instance stays test-sized; exact digits are required for folding
P = LabradorParams(n=2, r=2, kappa_override=16, exact_digits=True)


@pytest.fixture(scope="module")
def base():
    key = jax.random.key(31337)
    kw, ks, kv = jax.random.split(key, 3)
    witness = sampling.generate_witness(kw, P)
    state = structs.generate_state(ks, witness, P)
    crs = CRS.create(P, seed=0xEC)
    proof = prover.prove(P, witness, state, crs, kv, decomp_mode="exact")
    return witness, state, crs, proof


def test_base_proof_verifies(base):
    _, state, crs, proof = base
    rep = verifier.verify_report(P, state, proof, crs, decomp_mode="exact")
    failed = [k for k, v in rep.items() if not bool(np.asarray(v))]
    assert not failed, f"checks failed: {failed}"


def test_folded_relation_holds(base):
    """The digit witness satisfies the folded relation exactly — the
    algebraic heart of recursion."""
    _, state, crs, proof = base
    p_new, w_new, s_new, layout = recursion.recursive_step(P, state, proof, crs)
    res = recursion.relation_residual(s_new.a_k, s_new.phi_k, s_new.b_k,
                                      w_new, p_new)
    assert int(res) == 0
    assert p_new.k_count == P.kappa + P.kappa_1 + P.kappa_2 + 3
    assert layout.r_new == layout.nz + layout.mu


def test_folded_relation_rejects_tampered_witness(base):
    _, state, crs, proof = base
    p_new, w_new, s_new, _ = recursion.recursive_step(P, state, proof, crs)
    w_bad = w_new.at[0, 0, 0].add(1)
    res = recursion.relation_residual(s_new.a_k, s_new.phi_k, s_new.b_k,
                                      w_bad % p_new.q, p_new)
    assert int(res) != 0


def test_recursive_prove_verify(base):
    """One level of recursion end-to-end: prove the folded instance and run
    the full check battery on it."""
    _, state, crs, proof = base
    p_new, w_new, s_new, _ = recursion.recursive_step(P, state, proof, crs)
    crs_new = CRS.create(p_new, seed=0x5EC0)
    kv = jax.random.key(99)
    proof_new = prover.prove(p_new, w_new, s_new, crs_new, kv,
                             decomp_mode="exact")
    assert bool(proof_new.jl_ok)
    assert bool(proof_new.b_pp_ok)
    rep = verifier.verify_report(p_new, s_new, proof_new, crs_new,
                                 decomp_mode="exact")
    failed = [k for k, v in rep.items() if not bool(np.asarray(v))]
    assert not failed, f"folded-instance checks failed: {failed}"


# ---------------------------------------------------------------------------
# Structured (streamed) recursion: recursion.fold / FoldedState
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folded_structured(base):
    _, state, crs, proof = base
    return recursion.fold(P, state, proof, crs)


def test_fold_matches_dense_relation(base, folded_structured):
    """fold() (streamed, O(M d) memory) and recursive_step() (dense
    (k', M, d) phi) define the SAME relation: witness, b_k, the dense
    family-0 row, and random-alpha contractions of phi and a all agree."""
    from labrador_tpu import protocol, sampling
    from labrador_tpu.ops import ntt as ntt_ops
    _, state, crs, proof = base
    p_d, w_d, s_dense, _ = recursion.recursive_step(P, state, proof, crs)
    p_new, w_new, st, _ = folded_structured
    assert p_new == p_d
    np.testing.assert_array_equal(np.asarray(w_new), np.asarray(w_d))
    np.testing.assert_array_equal(np.asarray(st.b_k), np.asarray(s_dense.b_k))
    np.testing.assert_array_equal(np.asarray(st.phi0),
                                  np.asarray(s_dense.phi_k[:1]))
    plan = ntt_ops.plan_for(p_new)
    alpha = sampling.uniform_zq(jax.random.key(5), (p_new.k_count, p_new.d),
                                p_new.q)
    alpha_hat = ntt_ops.ntt_fwd(alpha, plan)
    dense_phi = ntt_ops.ntt_inv_modq(protocol.phi_weighted_hat(
        alpha_hat, ntt_ops.ntt_fwd(s_dense.phi_k, plan), plan), plan)
    np.testing.assert_array_equal(np.asarray(dense_phi),
                                  np.asarray(st.phi_alpha_modq(alpha)))
    dense_a = ntt_ops.ntt_inv_modq(protocol.phi_weighted_hat(
        alpha_hat, ntt_ops.ntt_fwd(s_dense.a_k, plan), plan), plan)
    np.testing.assert_array_equal(np.asarray(dense_a),
                                  np.asarray(st.a_alpha_modq(alpha)))


def test_folded_residual_streamed(folded_structured):
    p_new, w_new, st, _ = folded_structured
    assert int(recursion.folded_residual(st, w_new, p_new)) == 0
    w_bad = (w_new.at[0, 0, 0].add(1)) % p_new.q
    assert int(recursion.folded_residual(st, w_bad, p_new)) != 0


@pytest.mark.slow
def test_structured_prove_verify_two_levels(folded_structured):
    """Prove + full verify on the structured folded instance, then fold
    THAT proof again (level 2) and prove + verify it — multi-level
    recursion with no dense relation anywhere.

    ``slow`` (about 6 minutes under the tier-1 command):
    ``labrador_tpu_torch/golden/two_level.json`` records this flow's
    transcripts, residuals and verify reports at the same seeds, its
    ``slow`` regenerator (tests/test_torch_two_level.py) runs the same JAX
    flow, and tier-1 holds the port's two levels to the file.

    Runs in a fresh subprocess: XLA segfaults (compile or
    executable-serialize, reproducibly, at this test) on the level-2
    prove/verify programs (~150 MB serialized) when the suite process has
    been running for a while; a fresh interpreter compiles and runs them
    fine every time."""
    import os
    import subprocess
    import sys
    if os.environ.get("LABRADOR_TWO_LEVEL_INPROC") != "1":
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-x",
             __file__ + "::test_structured_prove_verify_two_levels"],
            env={**os.environ, "LABRADOR_TWO_LEVEL_INPROC": "1"},
            capture_output=True, text=True, timeout=3600)
        assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-2000:])
        return
    p1, w1, st1, _ = folded_structured
    crs1 = CRS.create(p1, seed=0x5EC0)
    proof1 = prover.prove(p1, w1, st1, crs1, jax.random.key(99),
                          decomp_mode="exact")
    assert bool(proof1.jl_ok) and bool(proof1.b_pp_ok)
    rep1 = verifier.verify_report(p1, st1, proof1, crs1, decomp_mode="exact")
    failed = [k for k, v in rep1.items() if not bool(np.asarray(v))]
    assert not failed, f"structured L1 checks failed: {failed}"

    # mu=6 keeps r2' = nz + mu small (r' drives the challenge-sampler
    # unroll and hence compile time; the relation is valid for any mu)
    p2, w2, st2, _ = recursion.fold(p1, st1, proof1, crs1, mu=6)
    assert int(recursion.folded_residual(st2, w2, p2)) == 0
    crs2 = CRS.create(p2, seed=0x5EC2)
    proof2 = prover.prove(p2, w2, st2, crs2, jax.random.key(7),
                          decomp_mode="exact")
    assert bool(proof2.jl_ok) and bool(proof2.b_pp_ok)
    rep2 = verifier.verify_report(p2, st2, proof2, crs2, decomp_mode="exact")
    failed2 = [k for k, v in rep2.items() if not bool(np.asarray(v))]
    assert not failed2, f"structured L2 checks failed: {failed2}"


def test_fold_kappa128_no_dense_materialization():
    """Folding a kappa=128 base instance (the reference's own kappa = n*d
    rule) — the dense relation would be a ~1 GB (k'=387, M~1500, d) tensor
    per CRT prime; the structured fold never builds it.  The streamed
    residual certifies the relation on the digit witness."""
    p128 = LabradorParams(n=2, r=2, exact_digits=True)   # kappa = n*d = 128
    key = jax.random.key(4242)
    kw, ks, kv = jax.random.split(key, 3)
    w = sampling.generate_witness(kw, p128)
    state = structs.generate_state(ks, w, p128)
    crs = CRS.create(p128, seed=0x128)
    proof = prover.prove(p128, w, state, crs, kv, decomp_mode="exact")
    p_new, w_new, st, layout = recursion.fold(p128, state, proof, crs)
    assert p_new.k_count == 3 * 128 + 3
    assert int(recursion.folded_residual(st, w_new, p_new)) == 0

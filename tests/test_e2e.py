"""End-to-end prove + verify (BASELINE.json config 1 scale) including
negative tests: a tampered transcript must fail the specific check that
guards it — the TPU analog of the reference's integration test
(main.rs:97-107 run in CI, rust.yml:22-27)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from labrador_tpu.params import LabradorParams
from labrador_tpu import sampling, structs, prover, verifier
from labrador_tpu.crs import CRS
from labrador_tpu.ops.modmath import mod_pos

P = LabradorParams(n=2, r=2)


@pytest.fixture(scope="module")
def setup():
    key = jax.random.key(1234)
    kw, ks, kv = jax.random.split(key, 3)
    witness = sampling.generate_witness(kw, P)
    state = structs.generate_state(ks, witness, P)
    crs = CRS.create(P, seed=0xC0FFEE)
    proof = prover.prove(P, witness, state, crs, kv)
    return witness, state, crs, proof


def test_prove_self_checks(setup):
    _, _, _, proof = setup
    assert bool(proof.jl_ok)
    assert bool(proof.b_pp_ok)


def test_verify_accepts(setup):
    _, state, crs, proof = setup
    rep = verifier.verify_report(P, state, proof, crs)
    failed = [k for k, v in rep.items() if not bool(v)]
    assert not failed, f"checks failed: {failed}"


def test_verify_rejects_tampered_z(setup):
    _, state, crs, proof = setup
    bad = proof.replace(z=mod_pos(proof.z.at[0, 3].add(1), P.q))
    rep = verifier.verify_report(P, state, bad, crs)
    assert not bool(rep["all"])
    assert not bool(rep["c15_az_vs_ct"])  # A z != sum c_i t_i


def test_verify_rejects_tampered_g(setup):
    _, state, crs, proof = setup
    bad_g = mod_pos(proof.g.at[0, 1, 0].add(1), P.q)
    rep = verifier.verify_report(P, state, proof.replace(g=bad_g), crs)
    assert not bool(rep["c08_g_symmetric"])


def test_verify_rejects_tampered_u1(setup):
    _, state, crs, proof = setup
    bad_u1 = mod_pos(proof.u_1.at[5, 7].add(1), P.q)
    rep = verifier.verify_report(P, state, proof.replace(u_1=bad_u1), crs)
    assert not bool(rep["c19_u1"])
    assert not bool(rep["all"])


def test_verify_rejects_wrong_crs(setup):
    _, state, _, proof = setup
    other = CRS.create(P, seed=0xBAD5EED)
    rep = verifier.verify_report(P, state, proof, other)
    assert not bool(rep["all"])


def test_verify_rejects_oversized_witness_digits(setup):
    """Blowing up t makes Check 14's exact norm bound fail."""
    _, state, crs, proof = setup
    bad_t = jnp.full_like(proof.t, P.q - 1)
    rep = verifier.verify_report(P, state, proof.replace(t=bad_t), crs)
    assert not bool(rep["all"])


def test_transcript_roundtrip_size(setup):
    _, _, _, proof = setup
    got = jax.device_get(proof)
    size = structs.transcript_size_in_bytes(got, P.q)
    assert 10_000 < size < 1_000_000
    # FS metric drops the sponge-derivable fields, so it is strictly
    # smaller (at this tiny config t dominates, so the gap is ~26%; at
    # large r the stored JL matrices dominate and the gap is many-fold)
    size_fs = structs.transcript_size_in_bytes(got, P.q, fs=True)
    assert 1_000 < size_fs < size


def test_exact_decomp_mode_e2e():
    """The corrected (exact balanced-digit) mode proves and verifies the
    FULL 14-check battery — c14 included: exact_digits params derive a
    deterministic worst-case beta' (|digit| <= b//2) that every honest
    transcript satisfies."""
    p_ex = LabradorParams(n=2, r=2, exact_digits=True)
    key = jax.random.key(99)
    kw, ks, kv = jax.random.split(key, 3)
    witness = sampling.generate_witness(kw, p_ex)
    state = structs.generate_state(ks, witness, p_ex)
    crs = CRS.create(p_ex, seed=0xE4AC7)
    proof = prover.prove(p_ex, witness, state, crs, kv, decomp_mode="exact")
    rep = verifier.verify_report(p_ex, state, proof, crs, decomp_mode="exact")
    failed = [k for k, v in rep.items() if not bool(np.asarray(v))]
    assert not failed, f"checks failed: {failed}"


def test_verify_f64_reference_norm_mode(setup):
    """The reference-faithful float-accumulated Check 14 also accepts this
    (small-q) proof — the mode exists to reproduce the reference's
    documented precision bug class at large q (README.md:10)."""
    _, state, crs, proof = setup
    rep = verifier.verify_report(P, state, proof, crs,
                                 norm_mode="f64_reference")
    assert bool(rep["c14_norm_bound"])
    assert bool(rep["all"])


@pytest.mark.time_limit(90)
def test_prove_pallas_backend_matches_xla(setup):
    """kernel_backend='pallas' produces the identical transcript (Ajtai via
    the fused kernel), interpret mode on CPU."""
    from jax.experimental.pallas import tpu as pltpu
    witness, state, crs, proof = setup
    kv = jax.random.key(1234)  # any key: we compare t, which is CRS-only
    with pltpu.force_tpu_interpret_mode():
        proof_p = prover.prove(P, witness, state, crs, kv,
                               kernel_backend="pallas")
    np.testing.assert_array_equal(np.asarray(proof_p.t), np.asarray(proof.t))

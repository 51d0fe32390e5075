"""Relations a user writes, in the port: ``structs.state_from_constraints``
against the JAX package's, then proved and verified by the port (the
counterparts of ``tests/test_custom_relations.py`` and
``tests/test_persistence.py::test_state_from_constraints_matches_generate``).

Two instances, at q = 8191 and at q = 4294967311 (exact digits there, as
the CLI's ``--big-q``):
  * a two-gate circuit over Rq with K = 2 families (n = 1, r = 4, kappa =
    64): s_0 * s_1 - s_2 = 0 (a_01 = a_10 = 2^-1, phi_2 = -1) and s_0 +
    s_1 - s_3 = 0; proved with ``prove`` / ``verify``;
  * a subset sum through F': phi_0 = sigma_inv(packed weights), so the
    constant term of <phi_0, s_0> is the plain inner product with the
    coefficient vector of s_0 (n = r = 2, kappa = 64); proved with
    ``prove_fs`` / ``verify_fs``.
A witness that breaks the multiplication gate, and a claimed sum that is
not the subset's, are rejected.  The JAX side is
``state_from_constraints`` only.  Tolerance: exact.
"""

import importlib

import numpy as np
import pytest
import torch

from labrador_tpu_torch import keys, prover, sampling, structs, verifier
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.params import LabradorParams

BIG = dict(q_start=(1 << 32) - 1, exact_digits=True)
MODULI = {"small_q": {}, "big_q": BIG}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mode(p) -> str:
    return "exact" if p.exact_digits else "reference"


def circuit(extra: dict):
    """(params, witness, a_k, phi_k) of the two-gate circuit, numpy int64
    residues: x = X^5, y = 3 X^10, z = x * y = 3 X^15, w = x + y."""
    p = LabradorParams(n=1, r=4, k_count=2, kappa_override=64, **extra)
    d, q = p.d, p.q
    wit = np.zeros((4, 1, d), np.int64)
    wit[0, 0, 5] = 1
    wit[1, 0, 10] = 3
    wit[2, 0, 15] = 3
    wit[3, 0, 5] = 1
    wit[3, 0, 10] = 3
    a_k = np.zeros((2, p.r, p.r, d), np.int64)
    a_k[0, 0, 1, 0] = a_k[0, 1, 0, 0] = pow(2, q - 2, q)
    phi_k = np.zeros((2, p.r, p.n, d), np.int64)
    phi_k[0, 2, 0, 0] = q - 1        # -s_2
    phi_k[1, 0, 0, 0] = 1            # +s_0
    phi_k[1, 1, 0, 0] = 1            # +s_1
    phi_k[1, 3, 0, 0] = q - 1        # -s_3
    return p, wit, a_k, phi_k


def _sigma_inv_np(a: np.ndarray, q: int) -> np.ndarray:
    out = np.zeros_like(a)
    out[..., 0] = a[..., 0]
    out[..., 1:] = (-a[..., :0:-1]) % q
    return out


def subset_sum(extra: dict):
    """(params, witness, a_k, phi_k, target) of the subset sum."""
    p = LabradorParams(n=2, r=2, kappa_override=64, **extra)
    d, q = p.d, p.q
    rng = np.random.default_rng(14)
    pub = rng.integers(0, 1000, p.n * d)             # public weights
    w = rng.integers(0, 2, p.n * d)                  # secret selector
    wit = np.zeros((p.r, p.n, d), np.int64)
    wit[0] = w.reshape(p.n, d)
    wit[1, 0, 0] = 1                                 # dummy second vector
    a_k = np.zeros((1, p.r, p.r, d), np.int64)
    phi_k = np.zeros((1, p.r, p.n, d), np.int64)
    phi_k[0, 0] = _sigma_inv_np(pub.reshape(p.n, d) % q, q)
    return p, wit, a_k, phi_k, int((pub * w).sum() % q)


def _port_state(p, wit, a_k, phi_k):
    t = lambda x: torch.from_numpy(x)
    return structs.state_from_constraints(t(a_k), t(phi_k), t(wit), p)


def _jax_state(p, wit, a_k, phi_k):
    """The JAX package's state_from_constraints on the same residues
    (two-limb Zq2 at big q) and witness (int32), under one ``jax.jit``
    (a quarter of the eager ops' compile time)."""
    import jax
    import jax.numpy as jnp
    from labrador_tpu import structs as jstructs
    from labrador_tpu.ops import zq as jzq
    from labrador_tpu.params import LabradorParams as JaxParams
    jp = JaxParams(n=p.n, r=p.r, k_count=p.k_count,
                   kappa_override=p.kappa_override,
                   exact_digits=p.exact_digits, q_start=p.q_start)
    assert jp.q == p.q
    fn = jax.jit(lambda a, ph, w: jstructs.state_from_constraints(a, ph, w,
                                                                   jp))
    return fn(jzq.from_py(a_k, p.q), jzq.from_py(phi_k, p.q),
              jnp.asarray(wit, jnp.int32))


@pytest.mark.parametrize("instance", ["circuit", "subset_sum"])
@pytest.mark.parametrize("modulus", list(MODULI))
def test_state_from_constraints_matches_jax(instance, modulus):
    """b_k and b'_k of the port equal the JAX package's; the circuit's are
    zero (both gates hold), the subset sum's constant term is the sum."""
    from labrador_tpu.ops import zq as jzq
    make = circuit if instance == "circuit" else subset_sum
    p, wit, a_k, phi_k = make(MODULI[modulus])[:4]
    got = _port_state(p, wit, a_k, phi_k)
    want = _jax_state(p, wit, a_k, phi_k)
    np.testing.assert_array_equal(got.b_k.numpy(), jzq.to_py(want.b_k))
    np.testing.assert_array_equal(got.b_prime_k.numpy(),
                                  jzq.to_py(want.b_prime_k))
    if instance == "circuit":
        assert not got.b_k.any()
    else:
        assert int(got.b_prime_k[0]) == subset_sum(MODULI[modulus])[4]


@pytest.mark.parametrize("modulus", list(MODULI))
def test_rq_circuit_two_gates(modulus):
    """The circuit (K = 2) proves and verifies; z' = z + X^3 breaks the
    multiplication gate, and check 18 rejects the proof of it."""
    p, wit, a_k, phi_k = circuit(MODULI[modulus])
    state = _port_state(p, wit, a_k, phi_k)
    crs = CRS.create(p, seed=0xC1C)
    vkey = keys.key(5)
    proof = prover.prove(p, torch.from_numpy(wit), state, crs, vkey,
                         _mode(p))
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    rep = verifier.verify_report(p, state, proof, crs, decomp_mode=_mode(p))
    assert not [k for k, v in rep.items() if not v]

    bad = wit.copy()
    bad[2, 0, 3] += 1
    bad_proof = prover.prove(p, torch.from_numpy(bad), state, crs, vkey,
                             _mode(p))
    bad_rep = verifier.verify_report(p, state, bad_proof, crs,
                                     decomp_mode=_mode(p))
    assert not bad_rep["c18_agg_relation"] and not bad_rep["all"]


@pytest.mark.parametrize("modulus", list(MODULI))
def test_subset_sum_constant_term(modulus):
    """The subset sum proves and verifies non-interactively; a claimed sum
    that is off by one fails the b'' constant check."""
    p, wit, a_k, phi_k, target = subset_sum(MODULI[modulus])
    state = _port_state(p, wit, a_k, phi_k)
    assert int(state.b_prime_k[0]) == target
    crs = CRS.create(p, seed=0x55B)
    proof = prover.prove_fs(p, torch.from_numpy(wit), state, crs, _mode(p))
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    assert verifier.verify_fs(p, state, proof, crs, decomp_mode=_mode(p))

    lied = structs.State(**{**vars(state),
                            "b_prime_k": (state.b_prime_k + 1) % p.q})
    rep = verifier.verify_report(p, lied, proof, crs, decomp_mode=_mode(p))
    assert not rep["c21_b_pp_const"] and not rep["all_with_bpp"]


@pytest.mark.parametrize("modulus", list(MODULI))
def test_state_from_constraints_matches_generate(modulus):
    """Rebuilt from generate_state's own families, state_from_constraints
    gives generate_state's state."""
    p = LabradorParams(n=2, r=2, **MODULI[modulus])
    w = sampling.generate_witness(keys.key(4), p, "cpu")
    st = structs.generate_state(keys.key(5), w, p)
    st2 = structs.state_from_constraints(st.a_k, st.phi_k, w, p)
    for name in ("a_k", "phi_k", "b_k", "b_prime_k"):
        assert torch.equal(getattr(st2, name), getattr(st, name)), name


def test_example_custom_relation_runs():
    """The port's example proves and verifies on the CPU."""
    mod = importlib.import_module(
        "labrador_tpu_torch.examples.custom_relation")
    assert mod.main(device="cpu")

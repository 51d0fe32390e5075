"""The port's config-1 transcript on the reference-parity CRS against the
reference simulator (``utils/refsim.py``: the Rust prover's and
verifier's algorithm in independent numpy), the counterpart of
``tests/test_refsim_parity.py``.

One proof, from the port on the CPU: config 1 (n = r = 2, q = 8191, the
reference's ``main.rs`` demo) on ``MaterializedCRS.create_chacha(P,
bytes(range(32)))``, with witness, state and verifier key from
``keys.key(20240807)`` split in three, as the JAX fixture.  Each test runs
with the JAX package's ``refsim`` (on the JAX ``MaterializedCRS``) and with
the port's copy (on the port's), on the same inputs.  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from labrador_tpu_torch import keys, prover, sampling, structs, verifier
from labrador_tpu_torch.crs import MaterializedCRS
from labrador_tpu_torch.params import LabradorParams
from labrador_tpu_torch.utils import refsim

P = LabradorParams(n=2, r=2)
SEED = bytes(range(32))
FIELDS = ("t", "g", "u_1", "projection", "b_prime_prime", "h", "u_2", "z")


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    crs = MaterializedCRS.create_chacha(P, SEED, device="cpu")
    kw, ks, kv = keys.split(keys.key(20240807), 3)
    witness = sampling.generate_witness(kw, P, "cpu")
    state = structs.generate_state(ks, witness, P)
    proof = prover.prove(P, witness, state, crs, kv)
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    torch.set_num_threads(n)
    return witness, state, crs, proof


@pytest.fixture(scope="module")
def jax_crs():
    from labrador_tpu.crs import MaterializedCRS as JaxMaterializedCRS
    from labrador_tpu.params import LabradorParams as JaxParams
    return JaxMaterializedCRS.create_chacha(JaxParams(n=2, r=2), SEED)


@pytest.fixture(params=["port", "jax"])
def sim(request, setup, jax_crs):
    """(refsim module, the CRS it reads): the port's copy on the port's
    table, or the JAX package's on the JAX table."""
    if request.param == "port":
        return refsim, setup[2]
    from labrador_tpu.utils import refsim as jax_refsim
    return jax_refsim, jax_crs


def _tampered(proof, field: str, idx):
    x = getattr(proof, field).clone()
    x[idx] = (x[idx] + 1) % P.q
    return dataclasses.replace(proof, **{field: x})


def test_transcript_fields_match_reference_semantics(setup, sim):
    """Every derived transcript field equals the reference algorithm's on
    the same witness, state, CRS and challenges."""
    mod, crs = sim
    witness, state, _, proof = setup
    ref = mod.ref_prove(P, witness.numpy(), state, crs,
                        mod.extract_challenges(proof))
    for field in FIELDS:
        np.testing.assert_array_equal(
            getattr(proof, field).numpy(), ref[field],
            err_msg=f"transcript field {field!r} diverges from the "
            "reference's proofgen")


def test_reference_verifier_accepts_port_proof(setup, sim):
    mod, crs = sim
    _, state, _, proof = setup
    rep = mod.ref_verify(P, state, proof, crs)
    assert not [k for k, v in rep.items() if not v]


def test_reference_verifier_agrees_with_port_verifier(setup, sim):
    """Check by check, ``ref_verify`` equals the port's
    ``verify_report(norm_mode="f64_reference")`` on the valid proof and
    on one with z[0, 3] + 1, which both reject (check 15)."""
    mod, crs = sim
    _, state, port_crs, proof = setup
    for pf in (proof, _tampered(proof, "z", (0, 3))):
        ref = mod.ref_verify(P, state, pf, crs)
        got = verifier.verify_report(P, state, pf, port_crs,
                                     norm_mode="f64_reference")
        common = set(ref) & set(got)
        assert {"c08_g_symmetric", "c14_norm_bound", "c15_az_vs_ct",
                "c19_u1", "c20_u2"} <= common
        for k in sorted(common):
            assert bool(got[k]) == ref[k], k
    assert not ref["all"] and not ref["c15_az_vs_ct"]


def test_refsim_rejects_wrong_u1(setup, sim):
    """A wrong u_1 flips the reference verifier's u1 recomputation and
    nothing else."""
    mod, crs = sim
    _, state, _, proof = setup
    rep = mod.ref_verify(P, state, _tampered(proof, "u_1", (0, 0)), crs)
    assert [k for k, v in rep.items() if not v] == ["c19_u1", "all"]

"""``--big-q -R`` on the CPU: the JAX package's CLI flow and the port's
(``cli.run_flow``) from the same seed at the size of
tests/test_bigq_recursion.py (n = 2, r = 2, kappa = 16, exact digits, q =
4294967311; it folds to n' = 13, r' = 15, k' = 51) must agree exactly:
the base transcript, layout, the signed digit witness, the folded params,
every FoldedState field, the folded transcript field by field and its
bincode SHA-256 and fs size.  The port's folded residual is 0 and a
tampered witness breaks it, its dense relation agrees with its fold, and
its folded proof, and the JAX package's carried across, verify.  Also
keeps the ``recursion`` part of ``labrador_tpu_torch/golden/config1_bigq.json``
equal to what the JAX package gives; ``tests/test_torch_cuda.py`` holds
the card's run against it.

The JAX side pays one base proof, one fold and one folded prove, all
module-scoped.  Its folded verify (about a minute here) is left out: the
port's verifier runs on the JAX package's folded proof instead, and
tests/test_bigq_recursion.py verifies a big-q folded proof in JAX.  The
JAX package's ``folded_residual`` takes no signed big-q digit witness, so
the residual is the port's alone."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from labrador_tpu import prover as jprover
from labrador_tpu import recursion as jrecursion
from labrador_tpu import structs as jstructs
from labrador_tpu.crs import CRS as JCRS
from labrador_tpu.ops import zq as jzq

from labrador_tpu_torch import cli as tcli
from labrador_tpu_torch import interop
from labrador_tpu_torch import recursion as trecursion
from labrador_tpu_torch import structs as tstructs
from labrador_tpu_torch import verifier as tverifier
from test_torch_bigq import (CPU, GOLDEN, JPR, Q, TPR, TR_FIELDS, _eq,
                             _fields, jax_cli_base)
from test_torch_e2e import jax_transcript_sha256

SEED = 42
FOLDED_CRS_SEED = SEED ^ tcli.FOLDED_CRS_XOR
ST_FIELDS = ("c", "cc", "cphi", "a_fin", "phi0", "b_k")


def _params_fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@pytest.fixture(scope="module")
def jx():
    """The JAX side: the CLI's base proof at kappa = 16, its fold, and the
    folded prove with the folded CRS seed and key fold_in(kv, 1)."""
    run = jax_cli_base(JPR, SEED)
    p2, w2, st, layout = jrecursion.fold(JPR, run["state"], run["proof"],
                                         run["crs"])
    crs2 = JCRS.create(p2, seed=FOLDED_CRS_SEED)
    proof2 = jax.device_get(jprover.prove(
        p2, w2, st, crs2, jax.random.fold_in(run["kv"], 1),
        decomp_mode="exact"))
    return dict(run, p2=p2, w2=w2, st=st, layout=layout, crs2=crs2,
                proof2=proof2)


@pytest.fixture(scope="module")
def tx():
    """The port's ``--big-q -R --kappa 16`` flow from the same seed."""
    res = tcli.run_flow(2, 2, 16, SEED, CPU, recursion=True, big_q=True)
    f = res.folded
    return dict(state=res.state, crs=res.crs, proof=res.proof, p2=f.params,
                w2=f.witness, st=f.state, layout=f.state.layout, crs2=f.crs,
                proof2=f.proof, report2=f.report, residual=f.residual)


def test_bigq_base_transcript_equal(jx, tx, monkeypatch):
    for field in TR_FIELDS:
        _eq(getattr(tx["proof"], field), getattr(jx["proof"], field))
    assert tstructs.transcript_sha256(tx["proof"], Q) == \
        jax_transcript_sha256(jx["proof"], Q, monkeypatch)


def test_bigq_layout_and_params_equal(jx, tx):
    jl, tl = jx["layout"], tx["layout"]
    for f in dataclasses.fields(jl):
        if f.name != "params":
            assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    assert (tl.n_new, tl.r_new, tl.k_new) == (13, 15, 51)
    assert _params_fields(tx["p2"]) == _params_fields(jx["p2"])
    assert tx["p2"].q == Q and tx["p2"].kappa == 16


def test_bigq_digit_witness_equal(jx, tx):
    """The folded witness: exact balanced digits, signed, as in JAX."""
    _eq(tx["w2"], jx["w2"])
    assert int(tx["w2"].min()) < 0
    _eq(trecursion.build_witness(tx["layout"], tx["proof"]), jx["w2"])


@pytest.mark.parametrize("field", ST_FIELDS
                         + ("a_prime_k", "phi_prime_k", "b_prime_k"))
def test_bigq_folded_state_field_equal(jx, tx, field):
    _eq(getattr(tx["st"], field), getattr(jx["st"], field))


def test_bigq_a_alpha_equal(jx, tx):
    rng = np.random.default_rng(8)
    alpha = rng.integers(0, Q, (tx["p2"].k_count, tx["p2"].d))
    jalpha = interop.tensor(alpha, CPU)
    _eq(tx["st"].a_alpha_modq(jalpha),
        jx["st"].a_alpha_modq(jzq.from_py(alpha, Q)))


def test_bigq_folded_residual(tx):
    """0 on the digit witness; nonzero with one digit changed."""
    assert tx["residual"] == 0
    assert trecursion.folded_residual(tx["st"], tx["w2"], tx["p2"]) == 0
    w_bad = tx["w2"].clone()
    w_bad[0, 0, 0] += 1
    assert trecursion.folded_residual(tx["st"], w_bad, tx["p2"]) != 0


def test_bigq_dense_relation_matches_fold(tx):
    """recursive_step's dense relation at big q: the same params, witness
    and right-hand sides as the fold, satisfied exactly by the witness
    (tests/test_bigq_recursion.py's relation test) and broken by a tamper."""
    p2_d, w_d, s_dense, _ = trecursion.recursive_step(
        TPR, tx["state"], tx["proof"], tx["crs"])
    assert _params_fields(p2_d) == _params_fields(tx["p2"])
    assert torch.equal(w_d, tx["w2"])
    assert torch.equal(s_dense.b_k, tx["st"].b_k)
    assert torch.equal(s_dense.phi_k[:1], tx["st"].phi0)
    assert trecursion.relation_residual(s_dense.a_k, s_dense.phi_k,
                                        s_dense.b_k, w_d, p2_d) == 0
    w_bad = w_d.clone()
    w_bad[0, 0, 0] += 1
    assert trecursion.relation_residual(s_dense.a_k, s_dense.phi_k,
                                        s_dense.b_k, w_bad, p2_d) != 0


@pytest.mark.parametrize("field", TR_FIELDS)
def test_bigq_folded_transcript_field_equal(jx, tx, field):
    _eq(getattr(tx["proof2"], field), getattr(jx["proof2"], field))


def test_bigq_folded_bincode_and_fs_size_equal(jx, tx, monkeypatch):
    q = tx["p2"].q
    assert tstructs.transcript_sha256(tx["proof2"], q) == \
        jax_transcript_sha256(jx["proof2"], q, monkeypatch)
    assert tstructs.transcript_size_in_bytes(tx["proof2"], q, fs=True) == \
        jstructs.transcript_size_in_bytes(jx["proof2"], q, fs=True)


def test_bigq_folded_verifies(jx, tx):
    """Every check true on the port's folded proof and, carried across, on
    the JAX package's."""
    assert tx["proof2"].jl_ok and tx["proof2"].b_pp_ok
    assert all(tx["report2"].values()), tx["report2"]
    proof2 = interop.transcript_from_numpy(_fields(jx["proof2"], TR_FIELDS),
                                           CPU)
    assert tverifier.verify_report(tx["p2"], tx["st"], proof2, tx["crs2"],
                                   decomp_mode="exact") == tx["report2"]


def test_bigq_recursion_golden_matches_jax(jx, monkeypatch):
    g = json.loads(GOLDEN.read_text())["recursion"]
    cfg = g["config"]
    assert (cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"]) == \
        (JPR.n, JPR.r, JPR.kappa_override, SEED)
    assert cfg["crs_seed"] == SEED * tcli.CRS_SEED_MULT % 2**64
    assert cfg["folded_crs_seed"] == FOLDED_CRS_SEED
    p2 = jx["p2"]
    assert g["base"] == {
        "transcript_sha256": jax_transcript_sha256(jx["proof"], Q,
                                                   monkeypatch),
        "transcript_size_in_bytes_fs": jstructs.transcript_size_in_bytes(
            jx["proof"], Q, fs=True)}
    assert g["folded"] == {
        "n": p2.n, "r": p2.r, "k_count": p2.k_count, "kappa": p2.kappa,
        "beta_override": p2.beta_override,
        "transcript_sha256": jax_transcript_sha256(jx["proof2"], Q,
                                                   monkeypatch),
        "transcript_size_in_bytes_fs": jstructs.transcript_size_in_bytes(
            jx["proof2"], Q, fs=True)}


def test_bigq_port_flow_matches_golden(tx):
    """What tests/test_torch_cuda.py holds the card's run against."""
    g = json.loads(GOLDEN.read_text())["recursion"]
    assert tstructs.transcript_sha256(tx["proof"], Q) == \
        g["base"]["transcript_sha256"]
    assert tstructs.transcript_sha256(tx["proof2"], Q) == \
        g["folded"]["transcript_sha256"]
    assert tstructs.transcript_size_in_bytes(tx["proof2"], Q, fs=True) == \
        g["folded"]["transcript_size_in_bytes_fs"]

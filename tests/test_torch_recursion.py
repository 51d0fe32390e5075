"""Recursion on the CPU: the JAX package and the port fold the same base
proof (carried across with ``interop``) at the size of tests/test_recursion.py
(n = 2, r = 2, kappa = 16, exact digits; it folds to r' = 19, n' = 14,
k' = 51) and must agree exactly: layout, digit witness, folded params, every
FoldedState field and its alpha-contractions, the folded residual, the
folded transcript field by field, both size metrics and the folded
verify_report.  The port's prover also runs on the JAX package's folded
state, and the port's dense relation (recursive_step) is held against its
own fold.  The JAX side pays one base proof, one fold and one folded prove
+ verify, all module-scoped."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from labrador_tpu import prover as jprover
from labrador_tpu import recursion as jrecursion
from labrador_tpu import sampling as jsampling
from labrador_tpu import structs as jstructs
from labrador_tpu import verifier as jverifier
from labrador_tpu.crs import CRS as JCRS
from labrador_tpu.params import LabradorParams as JParams

from labrador_tpu_torch import cli as tcli
from labrador_tpu_torch import interop
from labrador_tpu_torch import prover as tprover
from labrador_tpu_torch import protocol as tprotocol
from labrador_tpu_torch import recursion as trecursion
from labrador_tpu_torch import structs as tstructs
from labrador_tpu_torch import verifier as tverifier
from labrador_tpu_torch.crs import CRS as TCRS
from labrador_tpu_torch.ops import ntt as tntt
from labrador_tpu_torch.params import LabradorParams as TParams

P_KW = dict(n=2, r=2, kappa_override=16, exact_digits=True)
JP, TP = JParams(**P_KW), TParams(**P_KW)
BASE_SEED, CRS_SEED = 31337, 0xEC
FOLDED_CRS_SEED, FOLDED_KEY = 0x5EC0, 99
ALPHA_KEY = 5
ST_FIELDS = ("c", "cc", "cphi", "a_fin", "phi0", "b_k")
STATE_FIELDS = ("a_k", "phi_k", "b_k", "a_prime_k", "phi_prime_k",
                "b_prime_k")
TR_FIELDS = jstructs.TRANSCRIPT_FIELDS + ("pi", "jl_ok", "b_pp_ok")
CPU = "cpu"


def _np(x):
    return np.asarray(x).astype(np.int64)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(got.astype(np.int64), _np(want))


def _fields(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _params_fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def _report(rep):
    return {k: bool(v) for k, v in rep.items()}


@pytest.fixture(scope="module")
def jx():
    """The JAX side: base proof, fold, folded prove + verify."""
    kw, ks, kv = jax.random.split(jax.random.key(BASE_SEED), 3)
    witness = jsampling.generate_witness(kw, JP)
    state = jstructs.generate_state(ks, witness, JP)
    crs = JCRS.create(JP, seed=CRS_SEED)
    proof = jax.device_get(jprover.prove(JP, witness, state, crs, kv,
                                         decomp_mode="exact"))
    p2, w2, st, layout = jrecursion.fold(JP, state, proof, crs)
    crs2 = JCRS.create(p2, seed=FOLDED_CRS_SEED)
    proof2 = jax.device_get(jprover.prove(
        p2, w2, st, crs2, jax.random.key(FOLDED_KEY), decomp_mode="exact"))
    report2 = _report(jverifier.verify_report(p2, st, proof2, crs2,
                                              decomp_mode="exact"))
    alpha = jsampling.uniform_zq(jax.random.key(ALPHA_KEY),
                                 (p2.k_count, p2.d), p2.q)
    w_bad = (w2.at[0, 0, 0].add(1)) % p2.q
    # jitted: eager dispatch of these streams compiles op by op, 5x slower
    residual = jax.jit(lambda s, w: jrecursion.folded_residual(s, w, p2))
    return dict(
        state=state, crs=crs, proof=proof, p2=p2, w2=w2, st=st,
        layout=layout, crs2=crs2, proof2=proof2, report2=report2,
        alpha=np.asarray(alpha),
        phi_alpha=np.asarray(jax.jit(lambda s, a: s.phi_alpha_modq(a))(
            st, alpha)),
        a_alpha=np.asarray(st.a_alpha_modq(alpha)),
        residual=int(residual(st, w2)), residual_bad=int(residual(st, w_bad)))


@pytest.fixture(scope="module")
def tx(jx):
    """The port folds the JAX base proof, carried across, and proves and
    verifies the folded instance with the same seeds."""
    state = interop.state_from_numpy(_fields(jx["state"], STATE_FIELDS), CPU)
    proof = interop.transcript_from_numpy(_fields(jx["proof"], TR_FIELDS),
                                          CPU)
    crs = interop.crs_from_words(np.asarray(jx["crs"].key), TP)
    p2, w2, st, layout = trecursion.fold(TP, state, proof, crs)
    crs2 = TCRS.create(p2, seed=FOLDED_CRS_SEED)
    kv2 = interop.key_from_words(
        jax.random.key_data(jax.random.key(FOLDED_KEY)))
    proof2 = tprover.prove(p2, w2, st, crs2, kv2, decomp_mode="exact")
    report2 = tverifier.verify_report(p2, st, proof2, crs2,
                                      decomp_mode="exact")
    return dict(state=state, crs=crs, proof=proof, p2=p2, w2=w2, st=st,
                layout=layout, crs2=crs2, kv2=kv2, proof2=proof2,
                report2=report2)


def test_make_layout_equal(jx, tx):
    jl, tl = jx["layout"], tx["layout"]
    for f in dataclasses.fields(jl):
        if f.name != "params":
            assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    assert (tl.r_new, tl.n_new, tl.k_new) == (19, 14, 51)
    assert tl.m_total == jl.m_total
    assert [tl.g_pos(0, 1, 1), tl.h_pos(1, 1, 0), tl.t_pos(1, 2, 3)] == \
        [jl.g_pos(0, 1, 1), jl.h_pos(1, 1, 0), jl.t_pos(1, 2, 3)]


def test_build_witness_equal(jx, tx):
    _eq(tx["w2"], jx["w2"])
    _eq(trecursion.build_witness(tx["layout"], tx["proof"]), jx["w2"])


def test_folded_params_equal(jx, tx):
    assert _params_fields(tx["p2"]) == _params_fields(jx["p2"])


@pytest.mark.parametrize("field", ST_FIELDS
                         + ("a_prime_k", "phi_prime_k", "b_prime_k"))
def test_folded_state_field_equal(jx, tx, field):
    _eq(getattr(tx["st"], field), getattr(jx["st"], field))


def test_alpha_contractions_equal(jx, tx):
    alpha = interop.tensor(jx["alpha"], CPU)
    _eq(tx["st"].phi_alpha_modq(alpha), jx["phi_alpha"])
    _eq(tx["st"].a_alpha_modq(alpha), jx["a_alpha"])


def test_folded_residual(jx, tx):
    assert jx["residual"] == 0
    assert trecursion.folded_residual(tx["st"], tx["w2"], tx["p2"]) == 0
    w_bad = tx["w2"].clone()
    w_bad[0, 0, 0] = (w_bad[0, 0, 0] + 1) % tx["p2"].q
    assert jx["residual_bad"] != 0
    assert trecursion.folded_residual(tx["st"], w_bad, tx["p2"]) == \
        jx["residual_bad"]


def test_dense_relation_matches_fold(tx):
    """The port's recursive_step (dense (k', M, d) relation) and its fold
    define the same relation, and the digit witness satisfies it exactly
    (tests/test_recursion.py::test_fold_matches_dense_relation)."""
    p2_d, w_d, s_dense, _ = trecursion.recursive_step(
        TP, tx["state"], tx["proof"], tx["crs"])
    p2, w2, st = tx["p2"], tx["w2"], tx["st"]
    assert _params_fields(p2_d) == _params_fields(p2)
    assert torch.equal(w_d, w2)
    assert torch.equal(st.b_k, s_dense.b_k)
    assert torch.equal(st.phi0, s_dense.phi_k[:1])
    plan = tntt.plan_for(p2)
    rng = np.random.default_rng(17)
    alpha = interop.tensor(rng.integers(0, p2.q, (p2.k_count, p2.d)), CPU)
    alpha_hat = tntt.ntt_fwd(alpha, plan)
    for dense, streamed in ((s_dense.phi_k, st.phi_alpha_modq(alpha)),
                            (s_dense.a_k, st.a_alpha_modq(alpha))):
        want = tntt.ntt_inv_modq(tprotocol.phi_weighted_hat(
            alpha_hat, tntt.ntt_fwd(dense, plan), plan), plan)
        assert torch.equal(want, streamed)
    assert trecursion.relation_residual(s_dense.a_k, s_dense.phi_k,
                                        s_dense.b_k, w2, p2) == 0
    w_bad = w2.clone()
    w_bad[0, 0, 0] = (w_bad[0, 0, 0] + 1) % p2.q
    assert trecursion.relation_residual(s_dense.a_k, s_dense.phi_k,
                                        s_dense.b_k, w_bad, p2) != 0


@pytest.mark.parametrize("field", TR_FIELDS)
def test_folded_transcript_field_equal(jx, tx, field):
    _eq(getattr(tx["proof2"], field), getattr(jx["proof2"], field))


@pytest.mark.parametrize("fs", [False, True], ids=["interactive", "fs"])
def test_folded_size_in_bytes_equal(jx, tx, fs):
    q = tx["p2"].q
    assert tstructs.transcript_size_in_bytes(tx["proof2"], q, fs) == \
        jstructs.transcript_size_in_bytes(jx["proof2"], q, fs)


def test_folded_verify_report_equal(jx, tx):
    assert tx["report2"] == jx["report2"]
    assert all(tx["report2"].values())


def test_port_prover_on_jax_folded_state(jx, tx):
    """The JAX FoldedState and layout, carried across, give the port's
    prover and verifier the JAX package's folded transcript and report."""
    p2 = interop.params_from_fields(_params_fields(jx["p2"]))
    base = interop.params_from_fields(_params_fields(jx["layout"].params))
    layout = interop.layout_from_fields(
        {f.name: getattr(jx["layout"], f.name)
         for f in dataclasses.fields(jx["layout"])}, base)
    st = interop.folded_state_from_numpy(
        _fields(jx["st"], ST_FIELDS), layout,
        interop.crs_from_words(np.asarray(jx["st"].base_crs.key), base), CPU)
    w2 = interop.tensor(np.asarray(jx["w2"]), CPU)
    crs2 = interop.crs_from_words(np.asarray(jx["crs2"].key), p2)
    proof2 = tprover.prove(p2, w2, st, crs2, tx["kv2"], decomp_mode="exact")
    for field in TR_FIELDS:
        _eq(getattr(proof2, field), getattr(jx["proof2"], field))
    assert tverifier.verify_report(p2, st, proof2, crs2,
                                   decomp_mode="exact") == jx["report2"]


def test_cli_recursion_runs_on_cpu(capsys):
    """``python -m labrador_tpu_torch.cli -R --device cpu`` at this size
    (without --verbose, whose size metric of the folded proof costs more
    than the whole flow here)."""
    assert tcli.main(["-R", "--device", "cpu", "--kappa", "16"]) == 0
    assert "Error" not in capsys.readouterr().out

"""One level of recursion as a proof of its own (``prover.prove_recursive``,
``verifier.verify_recursive``, ``structs.RecursiveProof``) on the CPU at a
small big-q size (n = r = 2, kappa = 16, mu = 4), held bit for bit to the
benchmark's plain reference (``perfbench/reference/recursion.py``, which
builds the folded relation family block by family block from the base
CRS).  No JAX: the fold itself is held to the JAX package in
tests/test_torch_recursion.py and tests/test_torch_bigq_recursion.py."""

import dataclasses
import hashlib

import pytest
import torch

from labrador_tpu_torch import cli, keys, prover, recursion, structs, verifier
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.params import LabradorParams
from perfbench.reference import instance
from perfbench.reference import recursion as ref_recursion
from perfbench.reference import structs as ref_structs

CONFIG = {"params": dict(n=2, r=2, kappa_override=16, exact_digits=True,
                         q_start=(1 << 32) - 1)}
MU, KAPPA_NEW = 4, 16
SEED = 2**31 + 1717


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _to_reference(rp):
    return ref_recursion.RecursiveProof(
        ref_structs.Transcript(**_fields(rp.base)), int(rp.beta_new),
        ref_structs.Transcript(**_fields(rp.folded)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Thousands of small torch ops: two intra-op threads, as the other
    port files under the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Two statements of one pool; the program's and the reference's
    recursive proofs of statement 0 and both verifiers' reports."""
    ref_p = instance.make_params(CONFIG)
    p = LabradorParams(**CONFIG["params"])
    pool = instance.make_pool(ref_p, SEED, 2, "cpu")
    crs = CRS(key=pool.crs.key, params=p)
    states = [structs.State(**_fields(s)) for s in pool.states]
    vk = pool.verifier_key(0)
    key = keys.Key(vk.k0, vk.k1)
    rp = prover.prove_recursive(p, pool.witnesses[0], states[0], crs, key,
                                MU, KAPPA_NEW)
    ref = ref_recursion.prove_recursive(ref_p, pool.witnesses[0],
                                        pool.states[0], pool.crs, vk, MU,
                                        KAPPA_NEW)
    return dict(p=p, ref_p=ref_p, pool=pool, crs=crs, states=states,
                key=key, rp=rp, ref=ref,
                report=verifier.verify_recursive(p, states[0], rp, crs, MU,
                                                 KAPPA_NEW),
                ref_report=ref_recursion.verify_recursive(
                    ref_p, pool.states[0], _to_reference(rp), pool.crs, MU,
                    KAPPA_NEW))


def _verdicts(run, rp, statement=0):
    """(program report, reference report) of ``rp`` on a statement."""
    return (verifier.verify_recursive(run["p"], run["states"][statement],
                                      rp, run["crs"], MU, KAPPA_NEW),
            ref_recursion.verify_recursive(
                run["ref_p"], run["pool"].states[statement],
                _to_reference(rp), run["pool"].crs, MU, KAPPA_NEW))


@pytest.mark.parametrize("part", ["base", "folded"])
def test_recursive_proof_fields_equal_the_reference(run, part):
    got, want = getattr(run["rp"], part), getattr(run["ref"], part)
    for name, x in _fields(got).items():
        y = getattr(want, name)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert torch.equal(x, y), name
    for name in structs.OPENING_FIELDS:
        assert (getattr(got, name).shape[0] == 0) == (part == "base")


def test_recursive_proof_beta_and_shape(run):
    rp, p = run["rp"], run["p"]
    assert rp.beta_new == run["ref"].beta_new
    assert 1 <= rp.beta_new <= recursion.beta_new_max(p)
    lay = recursion.make_layout(p, MU)
    assert (rp.folded.z.shape[0], rp.folded.t.shape[:2]) == (
        lay.n_new, (lay.r_new, KAPPA_NEW))
    assert bool(rp.folded.jl_ok) and bool(rp.folded.b_pp_ok)


@pytest.mark.parametrize("fs", [False, True])
def test_bincode_bytes_equal_the_reference(run, fs):
    q = run["p"].q
    got = b"".join(run["rp"].bincode_chunks(q, fs))
    want = b"".join(ref_recursion.bincode_chunks(run["ref"], q, fs))
    assert hashlib.sha256(got).digest() == hashlib.sha256(want).digest()
    # the base opening is four empty vectors: a count of 0 each
    base = b"".join(structs.bincode_chunks(run["rp"].base, q, fs))
    assert base.endswith(bytes(32)) and got.startswith(base)


def test_report_equals_the_reference_and_accepts(run):
    rep = run["report"]
    assert rep == run["ref_report"]
    assert rep["all"] and all(rep[k] for k in (
        "base_public", "beta_new_bound", "fold_statement", "folded",
        "base.c21_b_pp_const", "base.jl_norm", "folded.c14_norm_bound"))


def _with(rp, part=None, **changes):
    if part is None:
        return dataclasses.replace(rp, **changes)
    return dataclasses.replace(
        rp, **{part: dataclasses.replace(getattr(rp, part), **changes)})


def _bumped(x, idx, q, by=1):
    x = x.clone()
    x[idx] = (x[idx] + by) % q
    return x


TAMPERS = ["folded_u1", "projection_over_bound", "b_pp", "beta_over_bound",
           "other_statement"]


@pytest.mark.parametrize("tamper", TAMPERS)
def test_verifier_rejects_what_the_reference_rejects(run, tamper):
    rp, q = run["rp"], run["p"].q
    statement = 0
    if tamper == "folded_u1":
        bad, failed = _with(rp, "folded", u_1=_bumped(
            rp.folded.u_1, (0, 0), q)), "folded.c19_u1"
    elif tamper == "projection_over_bound":
        proj = rp.base.projection.clone()
        proj[0] = q // 2                    # centred: far over sqrt(128) beta
        bad, failed = _with(rp, "base", projection=proj), "base.jl_norm"
    elif tamper == "b_pp":
        bad, failed = _with(rp, "base", b_prime_prime=_bumped(
            rp.base.b_prime_prime, (0, 0), q)), "base.c21_b_pp_const"
    elif tamper == "beta_over_bound":
        bad = _with(rp, beta_new=recursion.beta_new_max(run["p"]) + 1)
        failed = "beta_new_bound"
    else:
        bad, failed, statement = rp, "base.c21_b_pp_const", 1
    got, want = _verdicts(run, bad, statement)
    assert got == want
    assert not got["all"] and not got[failed]
    if tamper == "other_statement":
        assert not got["folded"]


def test_fold_is_its_statement_and_witness_halves(run):
    """``fold`` = ``build_witness`` + beta' + ``fold_statement``, field for
    field, and the statement half reads no opening."""
    p, st, crs = run["p"], run["states"][0], run["crs"]
    w = run["pool"].witnesses[0]
    base = prover.prove(p, w, st, crs, run["key"], decomp_mode="exact")
    p2, w2, fst, lay = recursion.fold(p, st, base, crs, MU, KAPPA_NEW)
    lay_b = recursion.make_layout(p, MU)
    w_b = recursion.build_witness(lay_b, base)
    beta = recursion.witness_beta(w_b, p.q)
    p2_b, fst_b, lay_c = recursion.fold_statement(
        p, st, structs.without_opening(base), crs, MU, KAPPA_NEW, beta)
    assert p2 == p2_b and lay == lay_b == lay_c and torch.equal(w2, w_b)
    assert beta == p2.beta_override == run["rp"].beta_new
    for f in dataclasses.fields(fst):
        a, b = getattr(fst, f.name), getattr(fst_b, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert recursion.folded_residual(fst, w2, p2) == 0


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 11, 2**63 + 5])
def test_folded_crs_is_the_cli_seed_rule(seed):
    p = LabradorParams(**CONFIG["params"])
    base = CRS.create(p, seed=seed * cli.CRS_SEED_MULT % 2**64)
    p2 = recursion.folded_params(recursion.make_layout(p, MU), KAPPA_NEW, 99)
    assert recursion.folded_crs(base, p2) == CRS.create(
        p2, seed=seed ^ cli.FOLDED_CRS_XOR)


def test_save_and_load_round_trip(run, tmp_path):
    rp, q = run["rp"], run["p"].q
    path = str(tmp_path / "rp.npz")
    rp.save(path, q)
    back = structs.RecursiveProof.load(path, device="cpu")
    assert back.beta_new == rp.beta_new
    for part in ("base", "folded"):
        for name, x in _fields(getattr(rp, part)).items():
            y = getattr(getattr(back, part), name)
            assert x.shape == y.shape and torch.equal(x, y.to(x.dtype))
    assert back.transcript_size_in_bytes(q, fs=True) == \
        rp.transcript_size_in_bytes(q, fs=True)


def test_cli_recursion_at_mu(capsys):
    """``cli -R --big-q --mu 4``: prove_recursive and verify_recursive."""
    assert cli.main(["-R", "--big-q", "--kappa", "16", "--mu", "4",
                     "--device", "cpu"]) == 0
    assert "Error" not in capsys.readouterr().out
    res = cli.run_flow(2, 2, 16, 42, "cpu", recursion=True, big_q=True, mu=4)
    f = res.folded
    assert f.recursive_report["all"] and f.residual == 0
    assert f.state.layout.mu == 4 and torch.equal(f.recursive.folded.u_1,
                                                  f.proof.u_1)


def test_alpha_contraction_timed_apart_by_prover_and_verifier(run,
                                                              monkeypatch):
    """The folded prove reaches the alpha-contraction through
    ``prover.folded_phi_alpha`` once; the verifier through its folded
    ``verify_report``'s section ``alpha_contract``, not through the
    prover's function; a timer changes no verdict."""
    from labrador_tpu_torch.utils.profiling import PhaseTimer
    calls = []
    inner = prover.folded_phi_alpha

    def counted(*args):
        calls.append(args)
        return inner(*args)

    monkeypatch.setattr(prover, "folded_phi_alpha", counted)
    p, st, crs = run["p"], run["states"][0], run["crs"]
    rp = prover.prove_recursive(p, run["pool"].witnesses[0], st, crs,
                                run["key"], MU, KAPPA_NEW)
    assert len(calls) == 1
    timer = PhaseTimer("cpu")
    rep = verifier.verify_recursive(p, st, rp, crs, MU, KAPPA_NEW,
                                    timer=timer)
    assert len(calls) == 1 and rep == run["report"]
    assert {"base_public", "fold_statement", "folded_verify", "aggregates",
            "alpha_contract", "c15_az_vs_ct", "c19_u1",
            "c20_u2"} <= set(timer.phases)
    assert timer.phases["alpha_contract"] <= timer.phases["aggregates"] \
        <= timer.phases["folded_verify"]


def test_cli_folds_once(monkeypatch):
    """``-R`` folds the base proof once: the fold it checks is the one
    ``prove_recursive`` proves."""
    calls = []
    inner = recursion.fold

    def counted(*args, **kw):
        calls.append(args)
        return inner(*args, **kw)

    monkeypatch.setattr(recursion, "fold", counted)
    res = cli.run_flow(2, 2, 16, 7, "cpu", recursion=True, big_q=True, mu=4)
    f = res.folded
    assert len(calls) == 1 and f.recursive_report["all"]
    assert f.proof is f.recursive.folded and f.report["all_with_bpp"]
    assert f.params.beta_override == f.recursive.beta_new

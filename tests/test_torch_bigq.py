"""The port at the 2^32-scale modulus q = 4294967311 against the JAX
package on the CPU, exactly: the ops (the modulus and its CRT plan, the
CRS and sampler draws, the witness pre-shift, exact balanced digits, the
transforms, the Garner fold, mulmod), the big-q route of the ring product,
the plain versions of kernels 2-4 against the JAX package's Pallas kernels
in TPU-interpret mode and its XLA path (operands at their magnitude
bounds), and the ``--big-q`` flow at config 1 end to end: every transcript
field, both size metrics, the bincode SHA-256, the check report, the
tamper rejection of tests/test_bigq_pipeline.py, and the base part of
``labrador_tpu_torch/golden/config1_bigq.json``, regenerated from the JAX
package.  Inputs come from numpy seeds or equal key words on both sides.
The ``-R`` flow is in tests/test_torch_bigq_recursion.py."""

import dataclasses
import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_tpu import crs as jcrs
from labrador_tpu import prover as jprover
from labrador_tpu import sampling as jsampling
from labrador_tpu import structs as jstructs
from labrador_tpu import verifier as jverifier
from labrador_tpu import protocol as jprotocol
from labrador_tpu.ops import bigq as jbigq
from labrador_tpu.ops import ntt as jntt
from labrador_tpu.ops import prg as jprg
from labrador_tpu.ops import zq as jzq
from labrador_tpu.params import LabradorParams as JParams

from labrador_tpu_torch import cli as tcli
from labrador_tpu_torch import crs as tcrs
from labrador_tpu_torch import interop
from labrador_tpu_torch import protocol as tprotocol
from labrador_tpu_torch import sampling as tsampling
from labrador_tpu_torch import structs as tstructs
from labrador_tpu_torch import verifier as tverifier
from labrador_tpu_torch.crs import CRS as TCRS
from labrador_tpu_torch.interop import key_from_words
from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, polymul_cuda, u1_cuda
from labrador_tpu_torch.ops import modmath as tmodmath
from labrador_tpu_torch.ops import ntt as tntt
from labrador_tpu_torch.ops import prg as tprg
from labrador_tpu_torch.ops import ring_stream
from labrador_tpu_torch.ops import zq as tzq
from labrador_tpu_torch.params import LabradorParams as TParams
from labrador_tpu_torch.protocol import _tri_stream
from test_torch_e2e import jax_transcript_sha256

Q = 4294967311
BIG = dict(q_start=(1 << 32) - 1, exact_digits=True)
C1_KW = dict(n=2, r=2, **BIG)                        # --big-q config 1
R_KW = dict(n=2, r=2, kappa_override=16, **BIG)      # test_bigq_recursion
JP1, TP1 = JParams(**C1_KW), TParams(**C1_KW)
JPR, TPR = JParams(**R_KW), TParams(**R_KW)
CPU = "cpu"
# the Pallas Ajtai kernel's 4 signed int8 limbs cover |w| <= 127 (256^4 - 1)
# / 255; the XLA path and the port take any int32
PALLAS_W_MAX = 127 * (256**4 - 1) // 255
I32_MAX = 2**31 - 1


def _np(x):
    return jzq.to_py(x) if isinstance(x, jzq.Zq2) else \
        np.asarray(x).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want)


def _jkey(seed):
    return jax.random.key(seed)


def _tkey(jk):
    return key_from_words(np.asarray(jax.random.key_data(jk)))


def _i32(a):
    return jnp.asarray(a, jnp.int32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_params_and_plan_tables():
    assert TP1.q == JP1.q == Q
    for f in dataclasses.fields(JP1):
        assert getattr(TP1, f.name) == getattr(JP1, f.name), f.name
    assert (TP1.t_1, TP1.b_1, TP1.t_2, TP1.b_2) == (4, 1625, 3, 2782)
    jp, tp = jntt.plan_for(JP1), tntt.plan_for(TP1)
    assert tp.primes == jp.primes and len(tp.primes) == 6
    np.testing.assert_array_equal(tp.V, jp.V.astype(np.int64))
    np.testing.assert_array_equal(tp.W, jp.W.astype(np.int64))
    np.testing.assert_array_equal(tp.garner_inv, jp.garner_inv)
    assert tp.m_half_digits == tuple(int(v) for v in jp.m_half_digits)
    assert tp.prefix_mod_q == tuple(int(v) for v in jp.prefix_mod_q)
    assert tp.m_mod_q == jp.m_mod_q


@pytest.mark.parametrize("q", [65537, 1 << 32, 1 << 33])
def test_make_plan_rejects_what_jax_rejects(q):
    """The gap P_MAX < q <= 2^32 and q >= 2^33 raise at make_plan, as in
    the JAX package."""
    with pytest.raises(NotImplementedError):
        jntt.make_plan(q)
    with pytest.raises(NotImplementedError):
        tntt.make_plan(q)


def test_words_mod_q_is_the_64_bit_word_mod_q():
    """prg.words_mod_q against Python integers and the JAX package's
    emulated-u64 Barrett, at the edge words and on random words."""
    rng = np.random.default_rng(1)
    x0 = np.concatenate([[0, 0, 2**31, 2**32 - 1, 2**32 - 1, 1],
                         rng.integers(0, 2**32, 4000)])
    x1 = np.concatenate([[0, 1, 0, 2**32 - 1, 0, 15],
                         rng.integers(0, 2**32, 4000)])
    want = [(int(a) << 32 | int(b)) % Q for a, b in zip(x0, x1)]
    got = tprg.words_mod_q(_t(x0), _t(x1), Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    hi, lo = jbigq._u64_mod_q((_i32(x0.astype(np.uint32).view(np.int32)),
                               _i32(x1.astype(np.uint32).view(np.int32))), Q)
    _eq(got, jzq.from_words32(hi, lo))


def test_uniform_mod_q_and_crs_tiles():
    rng = np.random.default_rng(2)
    k0, k1 = (int(v) for v in rng.integers(0, 2**32, 2))
    offs = rng.integers(0, 2**40, 2000)
    want = jprg.uniform_mod_q(np.uint32(k0), np.uint32(k1),
                              (offs >> 32).astype(np.uint32),
                              (offs & 0xFFFFFFFF).astype(np.uint32), Q)
    _eq(tprg.uniform_mod_q(k0, k1, _t(offs), Q), want)
    jc, tc = jcrs.CRS.create(JPR, 0xB16), tcrs.CRS.create(TPR, 0xB16)
    _eq(tc.a_rows(3, 5, device=CPU), jc.a_rows(3, 5))
    _eq(tc.b_rows(1, 2, 4, 3, device=CPU), jc.b_rows(1, 2, 4, 3))
    _eq(tc.c_vec(0, 1, 2, device=CPU), jc.c_vec(0, 1, 2))
    _eq(tc.d_vec(1, 1, 3, device=CPU), jc.d_vec(1, 1, 3))
    _eq(tc.b_mat_dyn(7, col0=2, ncols=5, device=CPU),
        jc.b_mat_dyn(7, col0=2, ncols=5))


def test_samplers():
    jk = _jkey(13)
    tk = _tkey(jk)
    for jf, tf in ((jsampling.sample_psi, tsampling.sample_psi),
                   (jsampling.sample_omega, tsampling.sample_omega),
                   (jsampling.sample_alpha, tsampling.sample_alpha),
                   (jsampling.sample_beta, tsampling.sample_beta),
                   (jsampling.sample_jl_matrix, tsampling.sample_jl_matrix)):
        _eq(tf(tk, TP1, device=CPU), jf(jk, JP1))
    u = tsampling.uniform_zq(tk, (40, 64), Q, device=CPU)
    _eq(u, jsampling.uniform_zq(jk, (40, 64), Q))
    assert int(u.max()) > 2**31      # residues beyond the int32 range
    for i in range(3):
        jc = jsampling.sample_challenge(jax.random.fold_in(jk, i), JP1)
        tc = tsampling.sample_challenge(_tkey(jax.random.fold_in(jk, i)),
                                        TP1, device=CPU)
        _eq(tc, jc)
        assert int(tc.min()) < 0     # signed at big q, as in JAX


@pytest.mark.parametrize("kw", [C1_KW, dict(n=16, r=2, kappa_override=16,
                                            **BIG)], ids=["config1", "n16"])
def test_witness_and_state(kw):
    jp, tp = JParams(**kw), TParams(**kw)
    jk = _jkey(11)
    w = jsampling.generate_witness(jk, jp)
    tw = tsampling.generate_witness(_tkey(jk), tp, device=CPU)
    _eq(tw, w)
    assert int(tw.min()) >= 0 and int(tw.max()) < 2**30
    assert float((tw != 0).double().mean()) > 0.5     # a realistic witness
    ks = _jkey(12)
    st = jstructs.generate_state(ks, w, jp)
    tst = tstructs.generate_state(_tkey(ks), tw, tp)
    for f in ("a_k", "phi_k", "b_k", "a_prime_k", "phi_prime_k",
              "b_prime_k"):
        _eq(getattr(tst, f), getattr(st, f))


EDGES = np.array([0, 1, 2, Q // 2 - 1, Q // 2, Q // 2 + 1, Q - 2, Q - 1])


@pytest.mark.parametrize("base,nd", [(1625, 4), (2782, 3), (6551, 3),
                                     (4, 17), (13834, 3)])
def test_decompose_balanced_big(base, nd):
    rng = np.random.default_rng(base)
    x = np.concatenate([EDGES, rng.integers(0, Q, 500)]).reshape(-1, 4)
    want = jzq.decompose_balanced_big(jzq.from_py(x, Q), base, nd, Q)
    got = tzq.decompose_balanced_big(_t(x), base, nd, Q)
    _eq(got, want)
    assert int(got.abs().max()) <= base // 2
    rec = sum(got[k].numpy().astype(object) * base**k for k in range(nd))
    assert ((rec - x.astype(object)) % Q == 0).all()


def test_transforms_and_fold():
    jp, tp = jntt.plan_for(JP1), tntt.plan_for(TP1)
    rng = np.random.default_rng(4)
    x = np.concatenate([EDGES, rng.integers(0, Q, 3 * 64 - 8)]).reshape(3,
                                                                         64)
    xs = rng.integers(-(2**31), 2**31, (5, 64))        # signed int32 values
    jx, tx = jntt.ntt_fwd(jzq.from_py(x, Q), jp), tntt.ntt_fwd(_t(x), tp)
    _eq(tx, jx)
    _eq(tntt.ntt_fwd(_t(xs), tp), jntt.ntt_fwd(_i32(xs), jp))
    _eq(tntt.ntt_inv_modq(tx, tp), jntt.ntt_inv_modq(jx, jp))
    _eq(tntt.ntt_inv_modq(tx, tp), x)
    # the Garner fold on random per-prime residues, signed and unsigned:
    # equal to JAX and to the exact CRT over Python integers
    pv = np.asarray(tp.primes).reshape(-1, 1, 1)
    res = rng.integers(0, 2**62, (len(tp.primes), 40, 64)) % pv
    M = int(np.prod([int(p) for p in tp.primes], dtype=object))
    for signed in (True, False):
        got = tzq.fold_res_modq(_t(res), tp, signed)
        _eq(got, jzq.fold_res_modq(_i32(res), jp, signed))
        crt = np.zeros(res.shape[1:], dtype=object)
        for i, p in enumerate(tp.primes):
            mi = M // p
            crt = crt + res[i].astype(object) * (mi * pow(mi, -1, p))
        crt = crt % M
        if signed:
            crt = np.where(crt > M // 2, crt - M, crt)
        np.testing.assert_array_equal(got.numpy(),
                                      (crt % Q).astype(np.int64))


def test_mulmod_exact():
    rng = np.random.default_rng(5)
    a = np.concatenate([EDGES, rng.integers(0, Q, 992)])
    b = np.concatenate([EDGES[::-1], rng.integers(0, Q, 992)])
    want = (a.astype(object) * b.astype(object)) % Q
    np.testing.assert_array_equal(tmodmath.mulmod(_t(a), _t(b), Q).numpy(),
                                  want.astype(np.int64))
    c = Q - 1
    np.testing.assert_array_equal(tmodmath.mulmod(_t(a), c, Q).numpy(),
                                  ((a.astype(object) * c) % Q).astype(np.int64))


def test_polymul_takes_the_crt_route_at_big_q(monkeypatch):
    """negacyclic_polymul and _bhat route by q, not by device: at big q
    the CRT transforms even for operands on the card (stand-ins here that
    say is_cuda), equal to the JAX package's negacyclic_polymul_big; at
    small q the same stand-ins reach the kernel's launcher."""
    calls = []

    def spy(name):
        return lambda *args: calls.append(name) or name

    for name in ("negacyclic_polymul_plain", "negacyclic_polymul_bhat_plain",
                 "_launch_coef", "_launch_bhat"):
        monkeypatch.setattr(polymul_cuda, name, spy(name))
    on_card = type("OnCard", (), {"is_cuda": True})()
    big, small = tntt.plan_for(TP1), tntt.plan_for(TParams(n=2, r=2))
    for plan in (big, small):
        polymul_cuda.negacyclic_polymul(on_card, on_card, plan)
        polymul_cuda.negacyclic_polymul_bhat(on_card, on_card, plan)
    assert calls == ["negacyclic_polymul_plain",
                     "negacyclic_polymul_bhat_plain", "_launch_coef",
                     "_launch_bhat"]
    monkeypatch.undo()
    rng = np.random.default_rng(6)
    a = np.concatenate([EDGES, rng.integers(0, Q, 5 * 64 - 8)]).reshape(5,
                                                                         64)
    b = rng.integers(0, Q, (5, 64))
    got = polymul_cuda.negacyclic_polymul(_t(a), _t(b), big)
    np.testing.assert_array_equal(
        got.numpy(), jbigq.negacyclic_polymul_big(a, b, Q).astype(np.int64))
    bhat = tntt.ntt_fwd(_t(b), big)
    assert torch.equal(polymul_cuda.negacyclic_polymul_bhat(_t(a), bhat, big),
                       got)


# ---------------------------------------------------------------------------
# kernels 2-4: plain versions against the Pallas kernels and the XLA path
# ---------------------------------------------------------------------------

SEED = 0xB16B


@pytest.fixture(scope="module")
def kcase():
    """Operands at the magnitude bounds, made with numpy, at the recursion
    test size (kappa = 16; the Pallas interpret runs stay short)."""
    p = JPR
    rng = np.random.default_rng(7)

    def digits(base, shape):
        d = rng.integers(-(base // 2), base // 2 + 1, shape)
        d.reshape(-1)[:2] = [base // 2, -(base // 2)]
        return d

    w = rng.integers(-PALLAS_W_MAX, PALLAS_W_MAX + 1, (p.r, p.n, p.d))
    w.reshape(-1)[:2] = [PALLAS_W_MAX, -PALLAS_W_MAX]
    w_full = rng.integers(-I32_MAX, I32_MAX + 1, (p.r, p.n, p.d))
    w_full.reshape(-1)[:2] = [I32_MAX, -I32_MAX]
    return dict(p=p, jcrs=jcrs.CRS.create(p, SEED), tcrs=TCRS.create(TPR, SEED),
                plan=jntt.plan_for(p), w=w, w_full=w_full,
                t_dig=digits(p.b_1, (p.t_1, p.r, p.kappa, p.d)),
                g_dig=digits(p.b_2, (p.t_2, p.r, p.r, p.d)),
                h_dig=digits(p.b_1, (p.t_1, p.r, p.r, p.d)))


def _interpret():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("r_eff", ["r", 1])
def test_ajtai_plain_matches_pallas_and_xla(kcase, r_eff):
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas
    p, plan = kcase["p"], kcase["plan"]
    for name in ("w", "w_full"):
        w = kcase[name] if r_eff == "r" else kcase[name][:1]
        got = ajtai_cuda.ajtai_commit_plain(kcase["tcrs"], _t(w))
        # residues mod q in, the same result: the plain version centres
        _eq(ajtai_cuda.ajtai_commit_plain(kcase["tcrs"], _t(w % Q)), got)
        s_hat = jntt.ntt_fwd(_i32(w), plan)
        _eq(got, jprotocol.ajtai_commit(kcase["jcrs"], s_hat, p, plan))
        if name == "w" and r_eff == "r":      # one interpret run suffices
            with _interpret():
                want = ajtai_commit_pallas(kcase["jcrs"].key, _i32(w), p,
                                           plan)
            _eq(got, want)


@pytest.mark.time_limit(270)
def test_u1_bterm_plain_matches_pallas_and_xla(kcase):
    from labrador_tpu.ops.u1_pallas import u1_bterm_pallas
    p, plan = kcase["p"], kcase["plan"]
    t_dig = kcase["t_dig"]
    got = u1_cuda.u1_bterm_plain(kcase["tcrs"], _t(t_dig))
    with _interpret():
        want = u1_bterm_pallas(kcase["jcrs"].key, _i32(t_dig), p, plan)
    _eq(got, want)
    zero_g = jnp.zeros((p.t_2, p.r, p.r, p.d), jnp.int32)
    _eq(got, jprotocol.u1_from_digits(kcase["jcrs"], _i32(t_dig), zero_g, p,
                                      plan))


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("use", ["C", "D"])
def test_cd_sum_plain_matches_pallas_and_xla(kcase, use):
    from labrador_tpu.ops.cd_pallas import cd_sum_pallas
    p, plan, jc = kcase["p"], kcase["plan"], kcase["jcrs"]
    if use == "C":
        dig, base, t_used, b = kcase["g_dig"], jc._off_c, p.t_2, p.b_2
        want_xla = jntt.ntt_inv_modq(
            jprotocol.u1_rhs_hat(jc, _i32(dig), p, plan), plan)
    else:
        dig, base, t_used, b = kcase["h_dig"], jc._off_d, p.t_1, p.b_1
        want_xla = jprotocol.u2_from_digits(jc, _i32(dig), p, plan)
    got = cd_cuda.cd_sum_plain(kcase["tcrs"], _tri_stream(_t(dig), TPR),
                               base, t_used)
    with _interpret():
        want = cd_sum_pallas(jc.key, jprotocol._tri_stream(_i32(dig), p),
                             base, t_used, p, plan, digit_base=b)
    _eq(got, want)
    _eq(got, want_xla)


def test_big_operand_guard():
    """The big-q kernels' int64 products hold for operands in [-q/2, q)
    (signed values and residues): the wrappers' guard passes that range
    and raises beyond it; the kernels take the moduli make_plan takes, up
    to the largest prime below 2^33."""
    ring_stream.check_big_operand(
        _t([I32_MAX, -(2**31), -(Q // 2), Q - 1, 0]), Q, "w")
    for bad in (-(Q // 2) - 1, Q, -(Q - 1)):
        with pytest.raises(ValueError):
            ring_stream.check_big_operand(_t([0, bad]), Q, "w")
    for q in (Q, (1 << 33) - 9):
        ring_stream.check_q(q, 64)
        tntt.make_plan(q)
    for q in (65537, (1 << 33) + 17):
        with pytest.raises(ValueError):
            ring_stream.check_q(q, 64)
        with pytest.raises(NotImplementedError):
            tntt.make_plan(q)


def test_big_plain_takes_the_whole_operand_range():
    """The plain versions (and so the kernels they hold) centre signed
    values and residues alike, over the whole range [-q/2, q): a witness
    at +-q/2, at -2^31 (the int32 wrap of the verifier's check 15) and its
    residues give the same commitment; equal to Python integers."""
    _check_plain_operand_range(TPR)


def test_big_plain_at_the_top_of_the_range():
    """The same at the largest prime below 2^33, where the kernels' products
    of two centred values reach 2^64 (chip_smoke.py holds the kernel there
    against this plain version)."""
    p = TParams(**{**R_KW, "q_start": (1 << 33) - 9})
    assert p.q == (1 << 33) - 9
    _check_plain_operand_range(p)


def _check_plain_operand_range(p):
    q = p.q
    crs = TCRS.create(p, SEED)
    rng = np.random.default_rng(9)
    w = rng.integers(-(q // 2), q // 2 + 1, (1, p.n, p.d))
    w.reshape(-1)[:3] = [q // 2, -(q // 2), -(2**31)]
    got = ajtai_cuda.ajtai_commit_plain(crs, _t(w))
    _eq(ajtai_cuda.ajtai_commit_plain(crs, _t(w % q)), got)
    a = crs.a_rows(device=CPU).numpy().astype(object)     # (kappa, n, d)
    want = np.zeros((p.kappa, p.d), dtype=object)
    ws = w[0].astype(object)
    for k in range(p.d):
        for i in range(p.d):
            sign = 1 if k >= i else -1
            want[:, k] += sign * (a[:, :, i] * ws[None, :, (k - i) % p.d]
                                  ).sum(axis=1)
    np.testing.assert_array_equal(got[0].numpy(),
                                  (want % q).astype(np.int64))


# ---------------------------------------------------------------------------
# end to end: the --big-q flow at config 1 (labrador_tpu/cli.py --big-q)
# ---------------------------------------------------------------------------

GOLDEN = Path(__file__).resolve().parent.parent / "labrador_tpu_torch" \
    / "golden" / "config1_bigq.json"
FLOW_SEED = 42
STATE_FIELDS = ("a_k", "phi_k", "b_k", "a_prime_k", "phi_prime_k",
                "b_prime_k")
TR_FIELDS = jstructs.TRANSCRIPT_FIELDS + ("pi", "jl_ok", "b_pp_ok")


def _fields(obj, names):
    """Fields as they are: numpy arrays, or the JAX package's Zq2 pairs,
    which ``interop.tensor`` takes as they are."""
    return {n: getattr(obj, n) for n in names}


def _report(rep):
    return {k: bool(v) for k, v in rep.items()}


def jax_cli_base(p, seed: int) -> dict:
    """The JAX CLI's witness, CRS, state, exact-digit proof and report."""
    kw, ks, kv = jax.random.split(jax.random.key(seed), 3)
    witness = jsampling.generate_witness(kw, p)
    crs = jcrs.CRS.create(p, seed=seed * tcli.CRS_SEED_MULT % 2**64)
    state = jstructs.generate_state(ks, witness, p)
    proof = jax.device_get(jprover.prove(p, witness, state, crs, kv,
                                         decomp_mode="exact"))
    return dict(witness=witness, state=state, crs=crs, kv=kv, proof=proof)


@pytest.fixture(scope="module")
def jax_run():
    run = jax_cli_base(JP1, FLOW_SEED)
    run["report"] = _report(jverifier.verify_report(
        JP1, run["state"], run["proof"], run["crs"], decomp_mode="exact"))
    return run


@pytest.fixture(scope="module")
def torch_run():
    """The port's own ``--big-q`` flow from the same seed (its key streams
    for witness, CRS, state and challenges)."""
    res = tcli.run_flow(2, 2, 0, FLOW_SEED, CPU, big_q=True)
    return dict(witness=res.witness, state=res.state, crs=res.crs,
                proof=res.proof, report=res.report, flow=res)


def test_bigq_instance_equal(jax_run, torch_run):
    """Witness, CRS key and every state field equal the JAX CLI's."""
    _eq(torch_run["witness"], jax_run["witness"])
    assert torch_run["crs"].key == tuple(
        int(k) for k in np.asarray(jax_run["crs"].key))
    for name in STATE_FIELDS:
        _eq(getattr(torch_run["state"], name),
            getattr(jax_run["state"], name))


@pytest.mark.parametrize("field", TR_FIELDS)
def test_bigq_transcript_field_equal(jax_run, torch_run, field):
    _eq(getattr(torch_run["proof"], field), getattr(jax_run["proof"], field))


def test_bigq_transcript_conventions(torch_run):
    """Residue fields canonical in [0, q) with values beyond 2^32; the
    challenges signed, as the JAX package keeps them at big q."""
    proof = torch_run["proof"]
    for name in ("u_1", "u_2", "t", "z", "g", "h", "projection"):
        x = getattr(proof, name)
        assert int(x.min()) >= 0 and int(x.max()) < Q, name
    assert int(proof.u_1.max()) > 2**31
    assert int(proof.c.min()) < 0


@pytest.mark.parametrize("fs", [False, True], ids=["interactive", "fs"])
def test_bigq_size_in_bytes_equal(jax_run, torch_run, fs):
    got = tstructs.transcript_size_in_bytes(torch_run["proof"], Q, fs)
    assert got == jstructs.transcript_size_in_bytes(jax_run["proof"], Q, fs)
    assert got == (175_985 if fs else 206_314)


def test_bigq_bincode_bytes_equal(jax_run, torch_run, monkeypatch):
    assert tstructs.transcript_sha256(torch_run["proof"], Q) == \
        jax_transcript_sha256(jax_run["proof"], Q, monkeypatch)


def test_bigq_verify_report_equal(jax_run, torch_run):
    assert torch_run["report"] == jax_run["report"]
    assert all(torch_run["report"].values())


def test_bigq_port_verifies_jax_proof(jax_run, torch_run):
    proof = interop.transcript_from_numpy(_fields(jax_run["proof"],
                                                  TR_FIELDS), CPU)
    got = tverifier.verify_report(TP1, torch_run["state"], proof,
                                  torch_run["crs"], decomp_mode="exact")
    assert got == jax_run["report"]


def test_bigq_tamper_rejected(jax_run, torch_run):
    """tests/test_bigq_pipeline.py's tamper: one low limb of z flipped."""
    jz = jax_run["proof"].z
    lo = jnp.asarray(jz.lo)
    jbad = jax_run["proof"].replace(z=jzq.Zq2(jnp.asarray(jz.hi), lo.at[
        0, 0].set((lo[0, 0] + 1) % (1 << 16))))
    z = torch_run["proof"].z.clone()
    z[0, 0] = (z[0, 0] >> 16 << 16) | ((z[0, 0] + 1) & 0xFFFF)
    tbad = torch_run["proof"].replace(z=z)
    _eq(z, jbad.z)
    want = _report(jverifier.verify_report(JP1, jax_run["state"], jbad,
                                           jax_run["crs"],
                                           decomp_mode="exact"))
    got = tverifier.verify_report(TP1, torch_run["state"], tbad,
                                  torch_run["crs"], decomp_mode="exact")
    assert got == want
    assert not got["all"] and not got["c15_az_vs_ct"]


def test_bigq_save_transcript_members_equal(jax_run, torch_run, tmp_path):
    """Same .npy members (two-limb fields as __hi / __lo), names, dtypes
    and bytes."""
    jstructs.save_transcript(jax_run["proof"], str(tmp_path / "j.npz"))
    tstructs.save_transcript(torch_run["proof"], str(tmp_path / "t.npz"), Q)
    with zipfile.ZipFile(tmp_path / "j.npz") as zj, \
            zipfile.ZipFile(tmp_path / "t.npz") as zt:
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zt.read(name), name


def test_bigq_save_transcript_small_q_raises(torch_run, tmp_path):
    """A big-q transcript saved at a small modulus would lose every residue
    above 2^31 to the int32 cast: it raises and writes nothing."""
    path = tmp_path / "t.npz"
    with pytest.raises(ValueError, match="does not fit"):
        tstructs.save_transcript(torch_run["proof"], str(path),
                                 TParams(n=2, r=2).q)
    assert not path.exists()


def jax_golden_base(run: dict, monkeypatch) -> dict:
    """The base part of the golden record, regenerated from the JAX
    package."""
    proof = run["proof"]
    return {
        "transcript_sha256": jax_transcript_sha256(proof, Q, monkeypatch),
        "transcript_size_in_bytes": jstructs.transcript_size_in_bytes(proof,
                                                                      Q),
        "transcript_size_in_bytes_fs": jstructs.transcript_size_in_bytes(
            proof, Q, fs=True),
        "verify_report": run["report"],
    }


def test_bigq_golden_file_matches_jax(jax_run, monkeypatch):
    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    assert (cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"]) == \
        (JP1.n, JP1.r, 0, FLOW_SEED)
    assert cfg["q"] == Q and cfg["q_start"] == tcli.BIG_Q_START
    assert cfg["crs_seed"] == FLOW_SEED * tcli.CRS_SEED_MULT % 2**64
    assert golden["base"] == jax_golden_base(jax_run, monkeypatch)


def test_bigq_port_cli_flow_matches_golden(torch_run):
    """What chip_smoke.py holds the card's run against."""
    g = json.loads(GOLDEN.read_text())["base"]
    proof = torch_run["proof"]
    assert tstructs.transcript_sha256(proof, Q) == g["transcript_sha256"]
    assert tstructs.transcript_size_in_bytes(proof, Q, fs=True) == \
        g["transcript_size_in_bytes_fs"]
    assert torch_run["report"] == g["verify_report"]


def test_bigq_cli_cpu_verbose(torch_run, monkeypatch, capsys):
    """``cli --big-q --device cpu --verbose`` asks run_flow for the big-q
    flow and reports its proof, 206,314 B as the JAX CLI; the flow itself
    is the torch_run fixture's, not run a second time."""
    calls = []

    def flow(*args):
        calls.append(args)
        return torch_run["flow"]

    monkeypatch.setattr(tcli, "run_flow", flow)
    assert tcli.main(["--device", "cpu", "--big-q", "--verbose"]) == 0
    # n, r, kappa, seed, device, verbose, -R, --big-q, --fs, --phases, --ckpt
    assert calls == [(2, 2, 0, FLOW_SEED, "cpu", True, False, True, False,
                      False, "")]
    out = capsys.readouterr().out
    assert "Success: Proof Verified!" in out
    assert "(206314 B)" in out


# ---------------------------------------------------------------------------
# check 14's float mode at big q (tests/test_bigq_pipeline.py's crafted
# streams, through both packages)
# ---------------------------------------------------------------------------

def _four_squares(n: int) -> list[int]:
    """Any n >= 0 as a sum of four squares (Lagrange), values <= isqrt(n)."""
    import math
    a = math.isqrt(n)
    while a >= 0:
        r1 = n - a * a
        b = math.isqrt(r1)
        while b >= 0:
            r2 = r1 - b * b
            c = math.isqrt(r2)
            while c >= 0:
                r3 = r2 - c * c
                dd = math.isqrt(r3)
                if dd * dd == r3:
                    return [a, b, c, dd]
                c -= 1
            b -= 1
        a -= 1
    raise AssertionError("unreachable (Lagrange)")


def _craft_t_with_digit_total(p, target: int) -> np.ndarray:
    """t values (r, kappa, d) int64 whose exact balanced-digit squared sum
    is EXACTLY `target`: only the first 3 digit positions are used (values
    stay < q/2, so the balanced decomposition returns the intended
    digits).  A copy of tests/test_bigq_pipeline.py's helper."""
    n_entries = p.r * p.kappa * p.d
    slots = np.zeros((n_entries * 3,), np.int64)
    half = p.b_1 // 2
    rem = target
    i = 0
    while rem >= half * half and i < len(slots) - 4:
        slots[i] = half
        rem -= half * half
        i += 1
    assert i < len(slots) - 4, "target exceeds craftable digit budget"
    for v in _four_squares(rem):
        slots[i] = v
        i += 1
    digs = slots.reshape(n_entries, 3)
    vals = (digs[:, 0] + digs[:, 1] * p.b_1 + digs[:, 2] * p.b_1 ** 2)
    assert vals.max() < p.q // 2
    return vals.reshape(p.r, p.kappa, p.d)


# deltas from beta'^2 at which the float32 verdict differs from the exact
# one, on the streams below (XLA's order on the CPU)
C14_FLIPS = [-1, -278, -555]


def test_c14_float_mode_equals_jax_at_big_q(jax_run):
    """Streams whose exact digit total is beta'^2 + delta, delta across
    +-15,000: in ``f64_reference`` mode the port's verdict is the JAX
    package's on every one, including those where the float32 sum judges
    wrongly (pinned), and the exact mode judges each correctly."""
    proof = jax_run["proof"]
    jdig = {k: getattr(jprotocol, f"decompose_{k}")(getattr(proof, k), JP1,
                                                    "exact")
            for k in "zgh"}
    tdig = {k: interop.tensor(v, CPU) for k, v in jdig.items()}
    z = interop.tensor(proof.z, CPU)
    bound = int(JP1.beta_prime)
    rest = int(sum((np.asarray(d, np.int64) ** 2).sum()
                   for d in jdig.values()))
    flips = []
    for delta in [s * m for m in range(1, 15_000, 277) for s in (1, -1)]:
        t_vals = _craft_t_with_digit_total(JP1, bound + delta - rest)
        jt = jprotocol.decompose_t(jzq.from_py(t_vals, Q), JP1, "exact")
        tt = tprotocol.decompose_t(interop.tensor(t_vals, CPU), TP1, "exact")
        _eq(tt, jt)
        want = bool(jverifier.check14_norm_bound(
            JP1, proof.z, jdig["z"], jt, jdig["g"], jdig["h"],
            "f64_reference"))
        args = (TP1, z, tdig["z"], tt, tdig["g"], tdig["h"])
        assert tverifier.check14_norm_bound(*args, "f64_reference") == want, \
            delta
        assert tverifier.check14_norm_bound(*args, "exact") == (delta <= 0)
        if want != (delta <= 0):
            flips.append(delta)
    assert flips == C14_FLIPS

"""Parity of the PyTorch port's ops with the JAX package, module by module:
params (every derived field), modmath, ntt (plan tables too), rq,
decompose, prg, the jax.random-compatible key layer, CRS tiles and the
samplers.  Same inputs (numpy from
a seed, or the same key words) on both sides; every comparison is exact
equality.  Also the import-boundary check of the port."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_tpu import crs as jcrs
from labrador_tpu import sampling as jsampling
from labrador_tpu import structs as jstructs
from labrador_tpu.ops import decompose as jdecompose
from labrador_tpu.ops import modmath as jmodmath
from labrador_tpu.ops import ntt as jntt
from labrador_tpu.ops import prg as jprg
from labrador_tpu.ops import rq as jrq
from labrador_tpu import params as jparams
from labrador_tpu.params import LabradorParams, T_OPNORM
from labrador_tpu.utils import golden

from labrador_tpu_torch import crs as tcrs
from labrador_tpu_torch import keys as tkeys
from labrador_tpu_torch import params as tparams
from labrador_tpu_torch import sampling as tsampling
from labrador_tpu_torch import structs as tstructs
from labrador_tpu_torch.interop import key_from_words
from labrador_tpu_torch.ops import decompose as tdecompose
from labrador_tpu_torch.ops import modmath as tmodmath
from labrador_tpu_torch.ops import ntt as tntt
from labrador_tpu_torch.ops import polymul_cuda as tpolymul
from labrador_tpu_torch.ops import prg as tprg
from labrador_tpu_torch.ops import rq as trq

ROOT = Path(__file__).resolve().parent.parent
P1 = LabradorParams(n=2, r=2)                       # config 1
P_SMALL = LabradorParams(n=2, r=6, kappa_override=16)
PLAN_PARAMS = [P1, LabradorParams(n=16, r=16, kappa_override=256)]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64), _np(want))


def _jkey(seed):
    return jax.random.key(seed)


def _tkey(jk):
    return key_from_words(np.asarray(jax.random.key_data(jk)))


# ---------------------------------------------------------------------------
# params: the port's own copy derives every field as the JAX package does
# ---------------------------------------------------------------------------

PARAM_GRID = {
    "config1": dict(n=2, r=2),
    "config1_exact": dict(n=2, r=2, exact_digits=True),
    "2^14": dict(n=16, r=16, kappa_override=256),
    "2^14_exact": dict(n=16, r=16, kappa_override=256, exact_digits=True),
    "recursion_test": dict(n=2, r=2, kappa_override=16, exact_digits=True),
    "folded": dict(n=14, r=19, q=8191, k_count=51, l_count=1,
                   kappa_override=16, exact_digits=True, beta_override=380),
    "big_q": dict(n=2, r=2, q_start=(1 << 32) - 1, exact_digits=True),
}


@pytest.mark.parametrize("kw", list(PARAM_GRID.values()), ids=list(PARAM_GRID))
def test_params_derive_like_jax(kw):
    jp, tp = LabradorParams(**kw), tparams.LabradorParams(**kw)
    for f in dataclasses.fields(jp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert [f.name for f in dataclasses.fields(tp)] == \
        [f.name for f in dataclasses.fields(jp)]
    assert (tp.upper_bound, tp.inv2) == (jp.upper_bound, jp.inv2)


def test_params_helpers_like_jax():
    for start in (8191, 8192, (1 << 32) - 1):
        assert tparams.find_suitable_prime(start) == \
            jparams.find_suitable_prime(start)
    for q, b in ((8191, 9), (8191, 4), (4294967311, 35)):
        assert tparams._ceil_log(q, b) == jparams._ceil_log(q, b)
    for q, acc in ((8191, 1024), (8191, 1 << 20), (32513, 1542)):
        assert tparams.select_crt_primes(q, 64, acc) == \
            jparams.select_crt_primes(q, 64, acc)
    for name in ("D", "TAU", "T_OPNORM", "K_DEFAULT", "L_DEFAULT",
                 "Q_START_DEFAULT"):
        assert getattr(tparams, name) == getattr(jparams, name), name


# ---------------------------------------------------------------------------
# modmath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8191, 31873])
def test_mod_pos(m):
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31) + 2**20, 2**31 - 2**20, 4096)
    _eq(tmodmath.mod_pos(_t(x), m),
        jmodmath.mod_pos(jnp.asarray(x, jnp.int32), m))


def test_matmul_mod_matches_modmul_mm():
    rng = np.random.default_rng(2)
    q = P1.q
    a = rng.integers(0, q, (3, 5, 300))
    b = rng.integers(0, q, (3, 300, 7))
    want = jmodmath.modmul_mm(jnp.asarray(a, jnp.int32),
                              jnp.asarray(b, jnp.int32), q, batch_dims=1)
    _eq(tmodmath.matmul_mod(_t(a), _t(b), q, q - 1, q - 1), want)


def test_sum_sq_u64_and_u64_sum():
    rng = np.random.default_rng(3)
    x = rng.integers(-(2**31) + 1, 2**31, 1000)
    want = jmodmath.u64_to_py(jmodmath.sum_sq_u64(jnp.asarray(x, jnp.int32)))
    assert tmodmath.sum_sq_u64(_t(x)) == want
    assert want == sum(int(v) ** 2 for v in x) % 2**64
    y = rng.integers(0, 2**31 - 1, 5000)
    assert tmodmath.u64_sum(_t(y)) == \
        jmodmath.u64_to_py(jmodmath.u64_sum(jnp.asarray(y, jnp.int32)))


# ---------------------------------------------------------------------------
# ntt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PLAN_PARAMS, ids=["config1", "2^14"])
def test_plan_tables(p):
    jp, tp = jntt.plan_for(p), tntt.plan_for(p)
    assert tp.primes == jp.primes and tp.q == jp.q and tp.d == jp.d
    np.testing.assert_array_equal(tp.V, jp.V.astype(np.int64))
    np.testing.assert_array_equal(tp.W, jp.W.astype(np.int64))
    np.testing.assert_array_equal(tp.garner_inv, jp.garner_inv)
    assert tp.m_half_digits == tuple(int(v) for v in jp.m_half_digits)
    assert tp.prefix_mod_q == tuple(int(v) for v in jp.prefix_mod_q)
    assert tp.m_mod_q == jp.m_mod_q


def test_ntt_roundtrip_and_eval_ops():
    jp, tp = jntt.plan_for(P1), tntt.plan_for(P1)
    rng = np.random.default_rng(4)
    q = P1.q
    x = rng.integers(0, q, (3, 4, 64))
    y = rng.integers(0, q, (3, 4, 64))
    xs = rng.integers(-5, 6, (7, 64))                 # signed small values
    jx, tx = jntt.ntt_fwd(jnp.asarray(x, jnp.int32), jp), tntt.ntt_fwd(_t(x), tp)
    _eq(tx, jx)
    _eq(tntt.ntt_fwd(_t(xs), tp), jntt.ntt_fwd(jnp.asarray(xs, jnp.int32), jp))
    _eq(tntt.ntt_inv_modq(tx, tp), jntt.ntt_inv_modq(jx, jp))
    _eq(tntt.ntt_inv_modq(tx, tp), x)
    jy, ty = jntt.ntt_fwd(jnp.asarray(y, jnp.int32), jp), tntt.ntt_fwd(_t(y), tp)
    _eq(tntt.eval_mul(tx, ty, tp), jntt.eval_mul(jx, jy, jp))
    _eq(tntt.eval_matmul(tx, torch.swapaxes(ty, -3, -2), tp),
        jntt.eval_matmul(jx, jnp.swapaxes(jy, -3, -2), jp))
    pv = np.asarray(jp.primes)
    _eq(tntt._mod_sum_p(tx, tp, axis=2), jntt._mod_sum_p(jx, pv, axis=2))
    _eq(tntt.polyvec_inner_product(_t(x), _t(y), tp),
        jntt.polyvec_inner_product(jnp.asarray(x, jnp.int32),
                                   jnp.asarray(y, jnp.int32), jp))


def test_negacyclic_polymul_matches_schoolbook():
    tp = tntt.plan_for(P1)
    rng = np.random.default_rng(5)
    a = rng.integers(0, P1.q, (4, 64))
    b = rng.integers(0, P1.q, (4, 64))
    got = tpolymul.negacyclic_polymul(_t(a), _t(b), tp).numpy()
    for i in range(4):
        want = golden.negacyclic_mul(a[i], b[i], P1.q).astype(np.int64)
        np.testing.assert_array_equal(got[i], want)
    jp = jntt.plan_for(P1)
    _eq(got, jntt.negacyclic_polymul(jnp.asarray(a, jnp.int32),
                                     jnp.asarray(b, jnp.int32), jp))


# ---------------------------------------------------------------------------
# rq, decompose
# ---------------------------------------------------------------------------

def test_sigma_inv():
    rng = np.random.default_rng(6)
    a = rng.integers(0, P1.q, (5, 64))
    _eq(trq.sigma_inv(_t(a), P1.q), jrq.sigma_inv(jnp.asarray(a, jnp.int32),
                                                   P1.q))


@pytest.mark.parametrize("mode,base,nd", [("reference", 9, 4),
                                          ("reference", 14, 2),
                                          ("exact", 9, 5), ("exact", 4, 7)])
def test_decompose(mode, base, nd):
    rng = np.random.default_rng(7)
    q = P1.q
    x = rng.integers(0, q, (3, 64))
    if mode == "exact":
        x = np.where(x > q // 2, x - q, x)            # centred inputs
    want = jdecompose.decompose(jnp.asarray(x, jnp.int32), base, nd, mode)
    got = tdecompose.decompose(_t(x), base, nd, mode)
    _eq(got, want)
    _eq(tdecompose.reconstruct(got, base, q),
        jdecompose.reconstruct(jnp.asarray(want), base, q))


# ---------------------------------------------------------------------------
# prg and the key layer
# ---------------------------------------------------------------------------

def test_threefry_and_uniform_mod_q():
    rng = np.random.default_rng(8)
    k0, k1 = (int(v) for v in rng.integers(0, 2**32, 2))
    c0 = rng.integers(0, 2**32, 1000)
    c1 = rng.integers(0, 2**32, 1000)
    jx0, jx1 = jprg.threefry2x32(np.uint32(k0), np.uint32(k1),
                                 c0.astype(np.uint32), c1.astype(np.uint32))
    tx0, tx1 = tprg.threefry2x32(k0, k1, _t(c0), _t(c1))
    _eq(tx0, jx0)
    _eq(tx1, jx1)
    offs = rng.integers(0, 2**40, 1000)
    want = jprg.uniform_mod_q(np.uint32(k0), np.uint32(k1),
                              (offs >> 32).astype(np.uint32),
                              (offs & 0xFFFFFFFF).astype(np.uint32), P1.q)
    _eq(tprg.uniform_mod_q(k0, k1, _t(offs), P1.q), want)


@pytest.mark.parametrize("seed", [0, 7, 42, 1234, 2**31 - 1])
def test_key_streams(seed):
    jk, tk = _jkey(seed), tkeys.key(seed)
    assert _tkey(jk) == tk
    for a, b in zip(jax.random.split(jk, 5), tkeys.split(tk, 5)):
        assert _tkey(a) == b
    for data in (0, 1, 5, 2**32 - 1):
        assert _tkey(jax.random.fold_in(jk, data)) == tkeys.fold_in(tk, data)
    _eq(tkeys.bits(tk, (3, 7, 2), device="cpu"),
        jax.random.bits(jk, (3, 7, 2), jnp.uint32))
    perm = jax.random.permutation(jk, jnp.arange(64))
    _eq(tkeys.permutation(tk, torch.arange(64)), perm)
    _eq(tkeys.bernoulli(tk, 0.5, (256,), device="cpu"),
        jax.random.bernoulli(jk, 0.5, (256,)))


# ---------------------------------------------------------------------------
# CRS tiles at all four offset regions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [P1, P_SMALL], ids=["config1", "r6_k16"])
def test_crs_tiles(p):
    seed = 0xA17A1
    jc, tc = jcrs.CRS.create(p, seed), tcrs.CRS.create(p, seed)
    assert tuple(int(v) for v in np.asarray(jc.key)) == tc.key
    for name in ("_off_a", "_off_b", "_off_c", "_off_d"):
        assert getattr(tc, name) == getattr(jc, name)
    cpu = "cpu"
    _eq(tc.a_rows(3, 5, device=cpu), jc.a_rows(3, 5))
    _eq(tc.b_rows(1, 2, 4, 3, device=cpu), jc.b_rows(1, 2, 4, 3))
    _eq(tc.c_vec(0, 1, 1, device=cpu), jc.c_vec(0, 1, 1))
    _eq(tc.d_vec(1, p.r - 1, p.t_1 - 1, device=cpu),
        jc.d_vec(1, p.r - 1, p.t_1 - 1))
    _eq(tc.a_rows_dyn(2, 3, device=cpu), jc.a_rows_dyn(2, 3))
    m = p.r * p.t_1 - 1
    _eq(tc.b_mat_dyn(m, col0=1, ncols=3, device=cpu),
        jc.b_mat_dyn(m, col0=1, ncols=3))
    _eq(tc.b_mat_dyn(1, device=cpu), jc.b_mat_dyn(1))
    _eq(tc._expand_dyn(tc._off_b, 3, p.kappa_1 * p.kappa,
                       (2, 3, p.d), (p.kappa * p.d, p.d, 1), idx1=2,
                       stride1=p.d, device=cpu),
        jc._expand_dyn(jc._off_b, 3, p.kappa_1 * p.kappa,
                       (2, 3, p.d), (p.kappa * p.d, p.d, 1), idx1=2,
                       stride1=p.d))


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [P1, P_SMALL], ids=["config1", "r6_k16"])
def test_generate_witness_and_state(p):
    jk = jax.random.key(11)
    w = jsampling.generate_witness(jk, p)
    tw = tsampling.generate_witness(_tkey(jk), p, device="cpu")
    _eq(tw, w)
    ks = jax.random.key(12)
    st = jstructs.generate_state(ks, w, p)
    tst = tstructs.generate_state(_tkey(ks), tw, p)
    for f in ("a_k", "phi_k", "b_k", "a_prime_k", "phi_prime_k",
              "b_prime_k"):
        _eq(getattr(tst, f), getattr(st, f))


def test_verifier_samplers():
    jk = jax.random.key(13)
    tk = _tkey(jk)
    for jf, tf in ((jsampling.sample_psi, tsampling.sample_psi),
                   (jsampling.sample_omega, tsampling.sample_omega),
                   (jsampling.sample_alpha, tsampling.sample_alpha),
                   (jsampling.sample_beta, tsampling.sample_beta),
                   (jsampling.sample_jl_matrix, tsampling.sample_jl_matrix)):
        _eq(tf(tk, P_SMALL, device="cpu"), jf(jk, P_SMALL))
    _eq(tsampling.uniform_zq(tk, (3, 5), P1.q, device="cpu"),
        jsampling.uniform_zq(jk, (3, 5), P1.q))


def _port_draw_norms(key, p):
    """Operator norms of every candidate the port draws for one challenge."""
    k = tkeys.fold_in(key, 0)
    norms = []
    while True:
        c = tsampling._draw_challenge(k, p.d)
        norms.append(np.sqrt(tsampling.operator_norm_sq(c, p.d)))
        if norms[-1] <= T_OPNORM:
            return norms
        k = tkeys.fold_in(k, 1)


def test_200_challenges_match():
    """200 challenges over seeds: same polynomial as the JAX sampler, and
    every accept/reject decision at least 1e-3 from the bound T = 15, far
    beyond the float32 rounding of the JAX package's norm."""
    base = jax.random.key(2024)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(200))
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jsampling.sample_challenge(k, P1)))(jkeys))
    for i in range(200):
        tk = _tkey(jkeys[i])
        np.testing.assert_array_equal(
            tsampling.sample_challenge(tk, P1, device="cpu").numpy(),
            want[i].astype(np.int64))
        assert min(abs(v - T_OPNORM) for v in _port_draw_norms(tk, P1)) > 1e-3


# ---------------------------------------------------------------------------
# import boundary
# ---------------------------------------------------------------------------

def _imports(path: Path, seen=None):
    """The modules ``path`` imports, anywhere in it, and those that the
    modules of ``tests/`` it imports import in turn."""
    seen = set() if seen is None else seen
    seen.add(path)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name
            sibling = ROOT / "tests" / f"{name}.py"
            if sibling.exists() and sibling not in seen:
                yield from _imports(sibling, seen)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "labrador_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
       ROOT / "tests" / "test_torch_sharded.py",
       ROOT / "tests" / "port_golden.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No module of the port, none of chip_smoke.py, neither test file
    that runs on the card (the card's machine has no JAX) and no module of
    ``tests/`` that they import imports JAX or any module of the JAX
    package."""
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "labrador_tpu"), \
            f"{path} imports {mod}"

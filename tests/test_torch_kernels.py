"""The port's plain commitment kernels (ajtai_commit_plain, u1_bterm_plain,
cd_sum_plain) against the JAX package's Pallas kernels in TPU-interpret
mode and against its XLA path, exactly; at config 1 and at a shape whose
u2 stream (L = 84) is not a multiple of the Pallas step and whose C-term
runs t_2 = 2 < t_1 = 4 (the offset quirk).  Likewise the plain polymul
versions (negacyclic_polymul_plain, negacyclic_polymul_bhat_plain) against
the fused Pallas polymul and the XLA transforms: past one Pallas block
(padding), with two-sided broadcasting, and with a fixed, a per-row and a
random-residue evaluation-domain operand.  The CUDA kernels themselves
are held against these plain versions on a card by
``tests/test_torch_cuda.py``."""

import types

import numpy as np
import pytest
import torch

from labrador_tpu.params import LabradorParams

from labrador_tpu_torch.crs import CRS as TCRS
from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, polymul_cuda, u1_cuda
from labrador_tpu_torch.ops import ntt as tntt
from labrador_tpu_torch.protocol import _tri_stream

SHAPES = {"config1": LabradorParams(n=2, r=2),
          "r6_k16": LabradorParams(n=2, r=6, kappa_override=16)}
SEED = 0xC0DE


class Case:
    """One instance's inputs, made with numpy from a seed."""

    def __init__(self, p):
        rng = np.random.default_rng(p.r)
        self.p = p
        self.tcrs = TCRS.create(p, SEED)
        q = p.q
        self.w = rng.integers(0, q, (p.r, p.n, p.d))
        # digits as the protocol stores them: residues mod q of small
        # signed values (|digit| <= base // 2)
        self.t_dig = rng.integers(-(p.b_1 // 2), p.b_1 // 2 + 1,
                                  (p.t_1, p.r, p.kappa, p.d)) % q
        self.g_dig = rng.integers(-(p.b_2 // 2), p.b_2 // 2 + 1,
                                  (p.t_2, p.r, p.r, p.d)) % q
        self.h_dig = rng.integers(-(p.b_1 // 2), p.b_1 // 2 + 1,
                                  (p.t_1, p.r, p.r, p.d)) % q

    def t(self, a, device="cpu"):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)


@pytest.fixture(scope="module", params=list(SHAPES), ids=list(SHAPES))
def case(request):
    return Case(SHAPES[request.param])


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side: its modules, and interpret mode."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from labrador_tpu import protocol
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops import ntt, ntt_pallas
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas
    from labrador_tpu.ops.cd_pallas import cd_sum_pallas
    from labrador_tpu.ops.u1_pallas import u1_bterm_pallas
    return types.SimpleNamespace(
        jnp=jnp, interpret=pltpu.force_tpu_interpret_mode, protocol=protocol,
        CRS=CRS, ntt=ntt, ntt_pallas=ntt_pallas,
        ajtai_commit_pallas=ajtai_commit_pallas,
        cd_sum_pallas=cd_sum_pallas, u1_bterm_pallas=u1_bterm_pallas)


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.asarray(want).astype(np.int64))


def _j(jx, a):
    return jx.jnp.asarray(a, jx.jnp.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("r_eff", ["r", 1])
def test_ajtai_plain_matches_pallas_and_xla(case, jx, r_eff):
    p = case.p
    plan, jcrs = jx.ntt.plan_for(p), jx.CRS.create(p, SEED)
    w = case.w if r_eff == "r" else case.w[:1]
    got = ajtai_cuda.ajtai_commit_plain(case.tcrs, case.t(w))
    with jx.interpret():
        want_pallas = jx.ajtai_commit_pallas(jcrs.key, _j(jx, w), p, plan)
    _eq(got, want_pallas)
    s_hat = jx.ntt.ntt_fwd(_j(jx, w), plan)
    _eq(got, jx.protocol.ajtai_commit(jcrs, s_hat, p, plan))


@pytest.mark.time_limit(180)
def test_u1_bterm_plain_matches_pallas_and_xla(case, jx):
    p = case.p
    plan, jcrs = jx.ntt.plan_for(p), jx.CRS.create(p, SEED)
    got = u1_cuda.u1_bterm_plain(case.tcrs, case.t(case.t_dig))
    with jx.interpret():
        want_pallas = jx.u1_bterm_pallas(jcrs.key, _j(jx, case.t_dig), p,
                                         plan)
    _eq(got, want_pallas)
    # the XLA u1 with zero g digits is its B-term alone
    zero_g = jx.jnp.zeros((p.t_2, p.r, p.r, p.d), jx.jnp.int32)
    _eq(got, jx.protocol.u1_from_digits(jcrs, _j(jx, case.t_dig), zero_g, p,
                                        plan))


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("use", ["C", "D"])
def test_cd_sum_plain_matches_pallas_and_xla(case, jx, use):
    p = case.p
    plan, jcrs = jx.ntt.plan_for(p), jx.CRS.create(p, SEED)
    if use == "C":
        dig, base, t_used, b = case.g_dig, jcrs._off_c, p.t_2, p.b_2
        want_xla = jx.ntt.ntt_inv_modq(
            jx.protocol.u1_rhs_hat(jcrs, _j(jx, dig), p, plan), plan)
    else:
        dig, base, t_used, b = case.h_dig, jcrs._off_d, p.t_1, p.b_1
        want_xla = jx.protocol.u2_from_digits(jcrs, _j(jx, dig), p, plan)
    stream = _tri_stream(case.t(dig), p)
    got = cd_cuda.cd_sum_plain(case.tcrs, stream, base, t_used)
    with jx.interpret():
        want_pallas = jx.cd_sum_pallas(
            jcrs.key, jx.protocol._tri_stream(_j(jx, dig), p), base, t_used,
            p, plan, digit_base=b)
    _eq(got, want_pallas)
    _eq(got, want_xla)


def test_small_shape_exercises_padding_and_quirk():
    """The second shape is the one the module docstring promises."""
    p = SHAPES["r6_k16"]
    n_tri = p.r * (p.r + 1) // 2
    step = 4096 // p.d                   # cd_pallas lin indices per step
    assert (n_tri * p.t_1) > step and (n_tri * p.t_1) % step != 0
    assert p.t_2 < p.t_1


# -- kernel 1: the fused negacyclic polymul ----------------------------------

POLY_P = SHAPES["config1"]
POLY_ROWS = 1024 + 77            # ntt_pallas.BLOCK + 77: a padded grid


def _poly_inputs(kind: str):
    """(a, b) coefficient residues for one broadcasting case."""
    rng = np.random.default_rng(0xB10C)
    q, d = POLY_P.q, POLY_P.d
    if kind == "padded":
        return (rng.integers(0, q, (POLY_ROWS, d)),
                rng.integers(0, q, (POLY_ROWS, d)))
    # (d,) x (n, d): the recursion's a17 * cphi
    return rng.integers(0, q, (d,)), rng.integers(0, q, (5, d))


@pytest.mark.time_limit(60)
@pytest.mark.parametrize("kind", ["padded", "two_sided_broadcast"])
def test_polymul_plain_matches_pallas_and_xla(jx, kind):
    a, b = _poly_inputs(kind)
    jplan, tplan = jx.ntt.plan_for(POLY_P), tntt.plan_for(POLY_P)
    got = polymul_cuda.negacyclic_polymul_plain(_t(a), _t(b), tplan)
    assert tuple(got.shape) == np.broadcast_shapes(a.shape, b.shape)
    _eq(got, jx.ntt.negacyclic_polymul(_j(jx, a), _j(jx, b), jplan))
    # the Pallas entry point broadcasts its second operand to the first's
    # shape only: give it the larger operand first (the product commutes)
    big, small = (a, b) if a.ndim >= b.ndim else (b, a)
    with jx.interpret():
        want_pallas = jx.ntt_pallas.negacyclic_polymul_pallas(
            _j(jx, big), _j(jx, small), jplan)
    _eq(got, want_pallas)
    assert torch.equal(polymul_cuda.negacyclic_polymul(_t(a), _t(b), tplan),
                       got)


def _bhat_input(jx, kind: str, jplan):
    """(a, bhat) with bhat (P, 1, d) fixed, (P, N, d) per row, or random
    canonical per-prime residues (not the transform of any b mod q)."""
    rng = np.random.default_rng(0xB4A7)
    q, d, P = POLY_P.q, POLY_P.d, jplan.n_primes
    a = rng.integers(0, q, (POLY_ROWS, d))
    if kind == "random_residues":
        pv = np.asarray(jplan.primes).reshape(P, 1, 1)
        return a, rng.integers(0, 1 << 62, (P, POLY_ROWS, d)) % pv
    rows = 1 if kind == "fixed" else POLY_ROWS
    b = rng.integers(0, q, (rows, d))
    return a, np.asarray(jx.ntt.ntt_fwd(_j(jx, b), jplan))


@pytest.mark.time_limit(60)
@pytest.mark.parametrize("kind", ["fixed", "per_row", "random_residues"])
def test_polymul_bhat_plain_matches_pallas_and_xla(jx, kind):
    jplan, tplan = jx.ntt.plan_for(POLY_P), tntt.plan_for(POLY_P)
    a, bhat = _bhat_input(jx, kind, jplan)
    got = polymul_cuda.negacyclic_polymul_bhat_plain(_t(a), _t(bhat), tplan)
    assert tuple(got.shape) == a.shape
    want_xla = jx.ntt.ntt_inv_modq(jx.ntt.eval_mul(
        jx.ntt.ntt_fwd(_j(jx, a), jplan), _j(jx, bhat), jplan), jplan)
    _eq(got, want_xla)
    with jx.interpret():
        want_pallas = jx.ntt_pallas.negacyclic_polymul_pallas_bhat(
            _j(jx, a), _j(jx, bhat), jplan)
    _eq(got, want_pallas)

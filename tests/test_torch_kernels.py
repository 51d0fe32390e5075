"""The port's plain commitment kernels (ajtai_commit_plain, u1_bterm_plain,
cd_sum_plain) against the JAX package's Pallas kernels in TPU-interpret
mode and against its XLA path, exactly; at config 1 and at a shape whose
u2 stream (L = 84) is not a multiple of the Pallas step and whose C-term
runs t_2 = 2 < t_1 = 4 (the offset quirk).  On a CUDA machine, also each
CUDA kernel against its plain version.

JAX is imported only by the ``jx`` fixture, so on a card machine without
JAX ``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``
runs the CUDA case."""

import types

import numpy as np
import pytest
import torch

from labrador_tpu.params import LabradorParams

from labrador_tpu_torch.crs import CRS as TCRS
from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
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
    from labrador_tpu.ops import ntt
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas
    from labrador_tpu.ops.cd_pallas import cd_sum_pallas
    from labrador_tpu.ops.u1_pallas import u1_bterm_pallas
    return types.SimpleNamespace(
        jnp=jnp, interpret=pltpu.force_tpu_interpret_mode, protocol=protocol,
        CRS=CRS, ntt=ntt, ajtai_commit_pallas=ajtai_commit_pallas,
        cd_sum_pallas=cd_sum_pallas, u1_bterm_pallas=u1_bterm_pallas)


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.asarray(want).astype(np.int64))


def _j(jx, a):
    return jx.jnp.asarray(a, jx.jnp.int32)


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


@pytest.mark.cuda
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, crs = case.p, case.tcrs
    w = case.t(case.w, "cuda")
    t_dig = case.t(case.t_dig, "cuda")
    g_str = _tri_stream(case.t(case.g_dig, "cuda"), p)
    h_str = _tri_stream(case.t(case.h_dig, "cuda"), p)
    pairs = [
        (ajtai_cuda.ajtai_commit(crs, w), ajtai_cuda.ajtai_commit_plain(crs, w)),
        (ajtai_cuda.ajtai_commit(crs, w[:1]),
         ajtai_cuda.ajtai_commit_plain(crs, w[:1])),
        (u1_cuda.u1_bterm(crs, t_dig), u1_cuda.u1_bterm_plain(crs, t_dig)),
        (cd_cuda.cd_sum(crs, g_str, crs._off_c, p.t_2),
         cd_cuda.cd_sum_plain(crs, g_str, crs._off_c, p.t_2)),
        (cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
         cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)

"""The port's plain commitment kernels (ajtai_commit_plain, u1_bterm_plain,
cd_sum_plain) against the JAX package's Pallas kernels in TPU-interpret
mode and against its XLA path, exactly; at config 1 and at a shape whose
u2 stream (L = 84) is not a multiple of the Pallas step and whose C-term
runs t_2 = 2 < t_1 = 4 (the offset quirk).  Likewise the plain polymul
versions (negacyclic_polymul_plain, negacyclic_polymul_bhat_plain) against
the fused Pallas polymul and the XLA transforms: past one Pallas block
(padding), with two-sided broadcasting, and with a fixed, a per-row and a
random-residue evaluation-domain operand.  On a CUDA machine, also each
CUDA kernel against its plain version, kernels 2-4 in both their modes (the
big-q plain versions are held against JAX in tests/test_torch_bigq.py),
the tensor-core bhat and Ajtai kernels and the coefficient kernel on edge
inputs.

JAX is imported only by the ``jx`` fixture, so on a card machine without
JAX ``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``
runs the CUDA case."""

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


@pytest.mark.cuda
def test_cuda_polymul_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = tntt.plan_for(POLY_P)
    rng = np.random.default_rng(5)
    q, d, P = POLY_P.q, POLY_P.d, plan.n_primes

    def cu(x):
        return _t(x).to("cuda")

    a = rng.integers(0, q, (POLY_ROWS, d))
    b = rng.integers(0, q, (POLY_ROWS, d))
    pv = np.asarray(plan.primes).reshape(P, 1, 1)
    bh_fixed = tntt.ntt_fwd(cu(b[:1]), plan)
    bh_rand = cu(rng.integers(0, 1 << 62, (P, POLY_ROWS, d)) % pv)
    pairs = [
        (polymul_cuda.negacyclic_polymul(cu(a), cu(b), plan),
         polymul_cuda.negacyclic_polymul_plain(cu(a), cu(b), plan)),
        (polymul_cuda.negacyclic_polymul(cu(a[0]), cu(b[:5]), plan),
         polymul_cuda.negacyclic_polymul_plain(cu(a[0]), cu(b[:5]), plan)),
        (polymul_cuda.negacyclic_polymul_bhat(cu(a), bh_fixed, plan),
         polymul_cuda.negacyclic_polymul_bhat_plain(cu(a), bh_fixed, plan)),
        (polymul_cuda.negacyclic_polymul_bhat(cu(a), bh_rand, plan),
         polymul_cuda.negacyclic_polymul_bhat_plain(cu(a), bh_rand, plan)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    # the coefficient kernel's edge cases (tests/test_torch_coef_kernel.py)
    # at q = 8191 and P_MAX, against the plain version of the operands'
    # residues mod q (the plain version takes |x| < q)
    from test_torch_coef_kernel import KINDS, coef_inputs
    for q in (8191, 32513):
        qplan = tntt.make_plan(q)
        for kind in KINDS:
            ca, cb = coef_inputs(q, kind,
                                 np.random.default_rng(q + len(kind)), "cuda")
            got = polymul_cuda.negacyclic_polymul(ca, cb, qplan)
            want = polymul_cuda.negacyclic_polymul_plain(
                torch.remainder(ca, q), torch.remainder(cb, q), qplan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (q, kind)


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


@pytest.mark.cuda
@pytest.mark.parametrize("q_start", [(1 << 32) - 1, (1 << 33) - 9],
                         ids=["q4294967311", "q8589934583"])
def test_cuda_bigq_kernels_match_plain(q_start):
    """Kernels 2-4 in their big-q mode against their plain versions, on
    signed operands at their bounds (the JAX package's big-q convention; a
    witness up to q/2, the most the kernel takes) and on residues, at the
    2^32-scale modulus and at the largest prime below 2^33."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from labrador_tpu_torch.params import LabradorParams as TParams
    p = TParams(n=2, r=6, kappa_override=16, q_start=q_start,
                exact_digits=True)
    crs = TCRS.create(p, SEED)
    rng = np.random.default_rng(11)

    def signed(top, shape):
        x = rng.integers(-top, top + 1, shape)
        x.reshape(-1)[:2] = [top, -top]
        return _t(x).to("cuda")

    w = signed(p.q // 2, (p.r, p.n, p.d))
    w[0, 0, 2] = -(2**31)
    t_dig = signed(p.b_1 // 2, (p.t_1, p.r, p.kappa, p.d))
    g_str = _tri_stream(signed(p.b_2 // 2, (p.t_2, p.r, p.r, p.d)), p)
    h_str = _tri_stream(signed(p.b_1 // 2, (p.t_1, p.r, p.r, p.d)), p)
    pairs = [
        (ajtai_cuda.ajtai_commit(crs, w), ajtai_cuda.ajtai_commit_plain(crs, w)),
        (ajtai_cuda.ajtai_commit(crs, w % p.q),
         ajtai_cuda.ajtai_commit_plain(crs, w)),
        (u1_cuda.u1_bterm(crs, t_dig), u1_cuda.u1_bterm_plain(crs, t_dig)),
        (cd_cuda.cd_sum(crs, g_str, crs._off_c, p.t_2),
         cd_cuda.cd_sum_plain(crs, g_str, crs._off_c, p.t_2)),
        (cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
         cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    assert ajtai_cuda.KERNEL_BIG.launches and u1_cuda.KERNEL_BIG.launches \
        and cd_cuda.KERNEL_BIG.launches


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["C", "D"])
@pytest.mark.parametrize("q, base", [(8191, 9), (8191, 8191),
                                     (4294967311, 2), (4294967311, 1625),
                                     (4294967311, 65536),
                                     (8589934583, 1 << 24)])
def test_cuda_cd_digit_modes_match_plain(q, base, use):
    """Each digit-limb mode of the C/D kernel (1-2 limbs at small q, 1-4
    at big q) at the folded kappa_2 = 16 shape, where a block's warps split
    the stream, digits at the largest magnitude the limbs hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from labrador_tpu_torch.params import LabradorParams as TParams
    big = q > 8191
    p = TParams(n=13, r=15, q=q, k_count=51, l_count=1, kappa_override=16,
                exact_digits=True)
    n_limbs = u1_cuda.digit_limbs(base)
    assert n_limbs == {2: 1, 9: 1, 1625: 2, 8191: 2, 65536: 3,
                       1 << 24: 4}[base]
    top = min(base // 2, u1_cuda.limb_cover(n_limbs))
    rng = np.random.default_rng(base)
    crs = TCRS.create(p, SEED)
    base_off, t_used = ((crs._off_c, p.t_2) if use == "C"
                        else (crs._off_d, p.t_1))
    x = rng.choice([-top, top, 0, 1], (t_used, p.r, p.r, p.d))
    stream = _tri_stream(_t(x if big else x % p.q).to("cuda"), p)
    got = cd_cuda.cd_sum(crs, stream, base_off, t_used, base)
    want = cd_cuda.cd_sum_plain(crs, stream, base_off, t_used)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [8191, 4294967311])
def test_cuda_stream_kernels_raise_beyond_limbs(q):
    """The u1 and C/D kernels flag a digit one beyond their limbs as they
    load it, and the wrappers raise after the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from labrador_tpu_torch.params import LabradorParams as TParams
    p = TParams(n=13, r=15, q=q, k_count=51, l_count=1, kappa_override=16,
                exact_digits=True)
    object.__setattr__(p, "b_1", 9)              # one digit limb
    object.__setattr__(p, "b_2", 9)
    crs = TCRS.create(p, SEED)
    over = u1_cuda.limb_cover(1) + 1
    t_dig = torch.zeros((p.t_1, p.r, p.kappa, p.d), dtype=torch.int64)
    t_dig[1, 2, 3, 4] = -over
    h = torch.zeros((p.t_1, p.r, p.r, p.d), dtype=torch.int64)
    h[0, 5, 6, 7] = over
    h_str = _tri_stream(h.to("cuda") % q, p)
    with pytest.raises(ValueError, match="beyond"):
        u1_cuda.u1_bterm(crs, (t_dig % q).to("cuda"))
    with pytest.raises(ValueError, match="beyond"):
        cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1)
    h_str[h_str == over] = over - 1                  # within the limb
    assert torch.equal(cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
                       cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "fixed_edges", "per_row", "edges",
                                  "signed"])
@pytest.mark.parametrize("q", [8191, 32513])
def test_cuda_bhat_tensor_cores_match_plain(q, kind):
    """The tensor-core bhat kernel against its plain version: a fixed and
    a per-row operand, 0 and p - 1 in a and in bhat, signed and
    out-of-range int64 a; 1,001 rows (a partial last tile) and one row; at
    q = 8191 (3 CRT primes) and q = 32513 (4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = tntt.make_plan(q) if q != POLY_P.q else tntt.plan_for(POLY_P)
    P, d = plan.n_primes, plan.d
    pv = np.asarray(plan.primes).reshape(P, 1, 1)
    rng = np.random.default_rng(q + len(kind))
    for n in (1001, 1):
        a = rng.integers(0, q, (n, d))
        rows = 1 if kind.startswith("fixed") else n
        bhat = rng.integers(0, 1 << 62, (P, rows, d)) % pv
        if kind.endswith("edges"):
            a[: (n + 1) // 2] = rng.choice([0, q - 1], ((n + 1) // 2, d))
            bhat = rng.choice([0, 1], (P, rows, d)) * (pv - 1)
        if kind == "signed":
            a = rng.integers(-(1 << 62), 1 << 62, (n, d))
            a[0, :4] = [-(1 << 63), (1 << 63) - 1, -q + 1, -1]
        ca, cb = _t(a).to("cuda"), _t(bhat).to("cuda")
        got = polymul_cuda.negacyclic_polymul_bhat(ca, cb, plan)
        want = polymul_cuda.negacyclic_polymul_bhat_plain(ca, cb, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, n)


@pytest.mark.cuda
@pytest.mark.parametrize("r_eff", [1, 3, 16])
@pytest.mark.parametrize("q_start", [None, (1 << 32) - 1, (1 << 33) - 9],
                         ids=["q8191", "q4294967311", "q8589934583"])
def test_cuda_ajtai_tensor_cores_match_plain(q_start, r_eff):
    """The tensor-core Ajtai kernel against its plain version at r_eff in
    {1, 3, 16} (one vector, a group not filled, several groups), kappa =
    24 (3 row tiles) and n = 37 ring elements (a partial chunk); at big q a
    witness at +-q/2 and in the band above what four signed limbs hold,
    and residues up to q - 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from labrador_tpu_torch.params import LabradorParams as TParams
    extra = {} if q_start is None else dict(q_start=q_start,
                                            exact_digits=True)
    p = TParams(n=37, r=16, kappa_override=24, **extra)
    crs = TCRS.create(p, SEED + r_eff)
    rng = np.random.default_rng(r_eff)
    shape = (r_eff, p.n, p.d)
    if q_start is None:
        w = rng.integers(0, p.q, shape)
        w.reshape(-1)[:4] = [0, p.q - 1, p.q // 2, p.q // 2 + 1]
    else:
        h, four = p.q // 2, 127 * (256**4 - 1) // 255
        w = rng.integers(-h, h + 1, shape)
        band = rng.integers(four + 1, h + 1, w.size // 4)
        w.reshape(-1)[: band.size] = band * rng.choice([-1, 1], band.size)
        w.reshape(-1)[-5:] = [h, -h, four + 1, -four - 1, p.q - 1]
    w = _t(w).to("cuda")
    got = ajtai_cuda.ajtai_commit(crs, w)
    want = ajtai_cuda.ajtai_commit_plain(crs, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

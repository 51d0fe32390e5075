"""Pallas fused kernels must agree bit-for-bit with the XLA reference path
(run in TPU-interpret mode on CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from labrador_tpu.params import LabradorParams
from labrador_tpu.ops import ntt, ntt_pallas

P = LabradorParams(n=2, r=2)
PLAN = ntt.plan_for(P)


@pytest.mark.time_limit(60)
def test_fused_polymul_matches_xla():
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.integers(0, P.q, (500, 64)), jnp.int32)
    b = jnp.asarray(rng.integers(0, P.q, (500, 64)), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        got = ntt_pallas.negacyclic_polymul_pallas(a, b, PLAN)
    want = ntt.negacyclic_polymul(a, b, PLAN)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.time_limit(60)
def test_fused_polymul_block_padding():
    """Sizes above BLOCK exercise the grid + padding path."""
    rng = np.random.default_rng(8)
    n = ntt_pallas.BLOCK + 77
    a = jnp.asarray(rng.integers(0, P.q, (n, 64)), jnp.int32)
    b = jnp.asarray(rng.integers(0, P.q, (n, 64)), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        got = ntt_pallas.negacyclic_polymul_pallas(a, b, PLAN)
    want = ntt.negacyclic_polymul(a, b, PLAN)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.time_limit(60)
def test_fused_polymul_hoisted_bhat_matches_xla():
    """The hoisted-operand kernel (b pre-transformed, its forward paid
    once) must agree bit-for-bit with the XLA path — including above BLOCK
    (grid + padding)."""
    rng = np.random.default_rng(9)
    for n in (500, ntt_pallas.BLOCK + 33):
        a = jnp.asarray(rng.integers(0, P.q, (n, 64)), jnp.int32)
        b = jnp.asarray(rng.integers(0, P.q, (n, 64)), jnp.int32)
        bhat = ntt.ntt_fwd(b, PLAN)
        with pltpu.force_tpu_interpret_mode():
            got = ntt_pallas.negacyclic_polymul_pallas_bhat(a, bhat, PLAN)
        want = ntt.negacyclic_polymul(a, b, PLAN)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.time_limit(240)
def test_fused_ajtai_matches_xla():
    """The fused PRG + circulant-MXU-matmul Ajtai kernel must be
    bit-identical to the streamed XLA path (the second config exercises the
    K-chunked grid: n*d above the per-step block)."""
    import jax
    from labrador_tpu import sampling, protocol
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas

    for kwargs in (dict(n=2, r=2), dict(n=8, r=3, kappa_override=64)):
        p = LabradorParams(**kwargs)
        plan = ntt.plan_for(p)
        w = sampling.generate_witness(jax.random.key(11), p)
        s_hat = ntt.ntt_fwd(w, plan)
        crs = CRS.create(p, seed=0xA17A1)
        want = np.asarray(protocol.ajtai_commit(crs, s_hat, p, plan))
        with pltpu.force_tpu_interpret_mode():
            got = np.asarray(ajtai_commit_pallas(crs.key, w, p, plan))
        np.testing.assert_array_equal(got, want)


@pytest.mark.time_limit(360)
def test_fused_u1_bterm_matches_xla():
    """The fused u1 B-term kernel (PRG + circulant MXU matmul) must be
    bit-identical to the XLA streamed u1 path; checked through the full
    u1_from_digits composition (B-term kernel + XLA C-term)."""
    import jax
    from labrador_tpu import sampling, structs, prover, protocol
    from labrador_tpu.crs import CRS

    for kwargs in (dict(n=2, r=2, kappa_override=16),
                   dict(n=4, r=3, kappa_override=64)):
        p = LabradorParams(**kwargs)
        plan = ntt.plan_for(p)
        w = sampling.generate_witness(jax.random.key(21), p)
        s_hat = ntt.ntt_fwd(w, plan)
        crs = CRS.create(p, seed=0x0B1)
        t = protocol.ajtai_commit(crs, s_hat, p, plan)
        t_dig = protocol.decompose_t(t, p, "reference")
        g = ntt.ntt_inv_modq(protocol.gram_hat(s_hat, plan), plan)
        g_dig = protocol.decompose_g(g, p, "reference")
        want = np.asarray(protocol.u1_from_digits(crs, t_dig, g_dig, p,
                                                  plan))
        with pltpu.force_tpu_interpret_mode():
            got = np.asarray(protocol.u1_from_digits(
                crs, t_dig, g_dig, p, plan, use_pallas=True))
        np.testing.assert_array_equal(got, want)


@pytest.mark.time_limit(180)
def test_fused_u2_and_u1_cterm_match_xla():
    """The fused C/D-term kernel (ops/cd_pallas: PRG + circulant MXU
    matmul over the (triangle, digit) stream) must be bit-identical to the
    XLA batched sum, including the non-affine oc = tri*t_1 + k offset quirk
    (exercised whenever t_2 != t_1) and the zero-padded step grid."""
    import jax
    from labrador_tpu import sampling, protocol
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops.cd_pallas import digit_limb_ok

    for kwargs in (dict(n=2, r=2, kappa_override=16),
                   dict(n=4, r=3, kappa_override=32)):
        p = LabradorParams(**kwargs)
        assert digit_limb_ok(p.b_1) and digit_limb_ok(p.b_2)
        plan = ntt.plan_for(p)
        w = sampling.generate_witness(jax.random.key(31), p)
        s_hat = ntt.ntt_fwd(w, plan)
        crs = CRS.create(p, seed=0xCD)
        g = ntt.ntt_inv_modq(protocol.gram_hat(s_hat, plan), plan)
        g_dig = protocol.decompose_g(g, p, "reference")
        h_dig = protocol.decompose_h(g, p, "reference")  # any (t1,r,r,d)
        want_u2 = np.asarray(protocol.u2_from_digits(crs, h_dig, p, plan))
        with pltpu.force_tpu_interpret_mode():
            got_u2 = np.asarray(protocol.u2_from_digits(
                crs, h_dig, p, plan, use_pallas=True))
        np.testing.assert_array_equal(got_u2, want_u2)

        # the u1 C-term goes through the same kernel with base=_off_c and
        # t_used=t_2 (covered via the full u1 composition in
        # test_fused_u1_bterm_matches_xla; assert the direct path too)
        from labrador_tpu.ops.cd_pallas import cd_sum_pallas
        from labrador_tpu.ops import ntt as ntt_ops
        want_c = np.asarray(ntt_ops.ntt_inv_modq(
            protocol.u1_rhs_hat(crs, g_dig, p, plan), plan))
        with pltpu.force_tpu_interpret_mode():
            got_c = np.asarray(cd_sum_pallas(
                crs.key, protocol._tri_stream(g_dig, p), crs._off_c,
                p.t_2, p, plan))
        np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.time_limit(240)
def test_verify_report_pallas_backend_matches_xla():
    """verify_report(kernel_backend='pallas') — fused kernels inside checks
    15/19/20 — must produce the same per-check report as the XLA backend on
    a real proof."""
    import jax
    from labrador_tpu import sampling, structs, prover, verifier
    from labrador_tpu.crs import CRS

    p = LabradorParams(n=2, r=2, kappa_override=16)
    key = jax.random.key(41)
    kw, ks, kv = jax.random.split(key, 3)
    w = sampling.generate_witness(kw, p)
    state = structs.generate_state(ks, w, p)
    crs = CRS.create(p, seed=0x7E57)
    proof = prover.prove(p, w, state, crs, kv, kernel_backend="xla")
    want = verifier.verify_report(p, state, proof, crs,
                                  kernel_backend="xla")
    # kappa_override=16 shrinks the commitment rank below what the beta'
    # derivation assumes, so c14_norm_bound legitimately fails at this
    # config on BOTH backends; the kernels under test live in the CRS
    # re-expansion checks 15/19/20 — those must pass and the full reports
    # must agree check-for-check.
    for k in ("c15_az_vs_ct", "c19_u1", "c20_u2"):
        assert bool(want[k]), k
    with pltpu.force_tpu_interpret_mode():
        got = verifier.verify_report(p, state, proof, crs,
                                     kernel_backend="pallas")
    for k in want:
        assert bool(got[k]) == bool(want[k]), k


@pytest.mark.time_limit(120)
def test_fused_ajtai_kc_chunked():
    """A shape whose n*d exceeds the 8192 K-block: multiple K grid steps
    accumulate into the same output block."""
    import jax
    from labrador_tpu import sampling, protocol
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas, _pick_blocks

    p = LabradorParams(n=256, r=2, kappa_override=16)
    plan0 = ntt.plan_for(p)
    assert _pick_blocks(p.kappa, p.n * p.d, p.r * p.d,
                        len(plan0.primes))[1] < p.n * p.d
    plan = ntt.plan_for(p)
    w = sampling.generate_witness(jax.random.key(3), p)
    s_hat = ntt.ntt_fwd(w, plan)
    crs = CRS.create(p, seed=0xA17A2)
    want = np.asarray(protocol.ajtai_commit(crs, s_hat, p, plan))
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(ajtai_commit_pallas(crs.key, w, p, plan))
    np.testing.assert_array_equal(got, want)


@pytest.mark.time_limit(420)
def test_fused_kernels_bigq_match_xla():
    """Big-q (2^32-scale) fused kernels: in-kernel Barrett on the PRG
    words + multi-limb int8 circulants must stay bit-identical to the XLA
    streaming paths (ROADMAP item 4, round 3)."""
    import jax
    from labrador_tpu import sampling, protocol
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops import zq as zq_ops
    from labrador_tpu.ops.ajtai_pallas import ajtai_commit_pallas, digit_limbs

    p = LabradorParams(n=2, r=2, q_start=(1 << 32) - 1, kappa_override=16,
                       exact_digits=True)
    assert zq_ops.is_big(p.q)
    plan = ntt.plan_for(p)
    w = sampling.generate_witness(jax.random.key(77), p)
    s_hat = ntt.ntt_fwd(w, plan)
    crs = CRS.create(p, seed=0xB16B16)

    def eq(a, b, msg):
        np.testing.assert_array_equal(np.asarray(a.hi), np.asarray(b.hi),
                                      err_msg=msg)
        np.testing.assert_array_equal(np.asarray(a.lo), np.asarray(b.lo),
                                      err_msg=msg)

    # Ajtai
    want_t = protocol.ajtai_commit(crs, s_hat, p, plan)
    with pltpu.force_tpu_interpret_mode():
        got_t = ajtai_commit_pallas(crs.key, w, p, plan)
    eq(got_t, want_t, "ajtai big-q")

    # u1 (B-term via u1_pallas + C-term via cd_pallas) and u2 (cd_pallas);
    # the fused route engages whenever the digits fit two int8 limbs
    assert digit_limbs(p.b_1) <= 2 and digit_limbs(p.b_2) <= 2, \
        (p.b_1, p.b_2)
    t_dig = protocol.decompose_t(want_t, p, "exact")
    g = ntt.ntt_inv_modq(protocol.gram_hat(s_hat, plan), plan)
    g_dig = protocol.decompose_g(g, p, "exact")
    want_u1 = protocol.u1_from_digits(crs, t_dig, g_dig, p, plan)
    with pltpu.force_tpu_interpret_mode():
        got_u1 = protocol.u1_from_digits(crs, t_dig, g_dig, p, plan,
                                         use_pallas=True)
    eq(got_u1, want_u1, "u1 big-q")

    h_dig = protocol.decompose_h(g, p, "exact")   # any (t1, r, r, d)
    want_u2 = protocol.u2_from_digits(crs, h_dig, p, plan)
    with pltpu.force_tpu_interpret_mode():
        got_u2 = protocol.u2_from_digits(crs, h_dig, p, plan,
                                         use_pallas=True)
    eq(got_u2, want_u2, "u2 big-q")

"""Repairs of the port against the JAX package, on the CPU.

* The JL projection (``prover.jl_projection``): four int8 limbs of the
  centred witness, one int32-wrapping dot per limb, the emulated i64
  recombination, ``fits`` and the low word, equal to
  ``labrador_tpu.prover.jl_project`` at big and small q, with witness
  values at +-(2^31 - 1) and at the limb edges, through many chunks; exact
  above the 4,194,303 coefficients where the port's projection used to
  assert, and where the limb dots wrap int32 (above 2^24 coefficients).
* The challenge rejection decision (``sampling.challenge_rejected``):
  equal to ``operator_norm_exact(c) > 15`` of the JAX package, as XLA
  computes it on the CPU in float32, on 10^5 seeded numpy draws of signed
  permutations of the challenge multiset and on the 50 draws nearest 15
  out of 10^6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_tpu import prover as jprover
from labrador_tpu import sampling as jsampling
from labrador_tpu.params import LabradorParams as JParams, T_OPNORM

from labrador_tpu_torch import prover as tprover
from labrador_tpu_torch import sampling as tsampling
from labrador_tpu_torch.interop import key_from_words
from labrador_tpu_torch.params import LabradorParams as TParams

BIG = dict(n=2, r=2, kappa_override=16, q_start=(1 << 32) - 1,
           exact_digits=True)
SMALL = dict(n=2, r=2, kappa_override=16, exact_digits=True)
I32 = 1 << 31
# values at the int32 ends and at the edges of the signed 8-bit limbs
EDGES = [I32 - 1, -(I32 - 1), -I32, 127, 128, -128, -129, 255, 256, -256,
         32767, 32768, -32768, (1 << 23) - 1, 1 << 23, -(1 << 23),
         (1 << 24) - 1, -(1 << 24), 0, 1, -1]


def _witness(kind: str, p) -> np.ndarray:
    """(r, n*d) witness: 'edges' (the values above, then +-(2^31 - 1)
    with random signs), 'small' (a projection that fits and passes), or
    the small-q residues 'residues' (0, q-1, q/2 and q/2 + 1 among
    them)."""
    rng = np.random.default_rng(17)
    shape = (p.r, p.n * p.d)
    if kind == "edges":
        w = rng.choice([-1, 1], shape) * (I32 - 1)
        w.reshape(-1)[:len(EDGES)] = EDGES
    elif kind == "small":
        w = rng.integers(-3, 4, shape)
    else:
        w = rng.integers(0, p.q, shape)
        w.reshape(-1)[:4] = [0, p.q - 1, p.q // 2, p.q // 2 + 1]
    return w.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_jl(kind: str):
    """The JAX package's one JL attempt on the witness of ``kind``."""
    p = JParams(**(SMALL if kind == "residues" else BIG))
    w = _witness(kind, p)
    pi, proj, ok = jprover.jl_project(jax.random.key(5),
                                      jnp.asarray(w, jnp.int32), p)
    return np.asarray(pi), np.asarray(proj).astype(np.int64), bool(ok)


@pytest.mark.parametrize("chunk", [1 << 16, 64, 7])
@pytest.mark.parametrize("kind", ["edges", "small", "residues"])
def test_jl_project_matches_jax(kind, chunk, monkeypatch):
    monkeypatch.setattr(tprover, "JL_CHUNK", chunk)
    p = TParams(**(SMALL if kind == "residues" else BIG))
    jpi, jproj, jok = _jax_jl(kind)
    key = key_from_words(np.asarray(jax.random.key_data(jax.random.key(5))))
    pi, proj, ok = tprover.jl_project(
        key, torch.from_numpy(_witness(kind, p)), p)
    np.testing.assert_array_equal(pi.numpy(), jpi)
    np.testing.assert_array_equal(proj.numpy(), jproj)
    assert ok == jok
    assert ok == (kind == "small")


def _model_projection(pi: np.ndarray, w: np.ndarray):
    """The JAX arithmetic in numpy: int32 limbs, exact limb dots wrapped to
    int32, the emulated i64 recombination mod 2^64, fits, low word."""
    v = w.astype(np.int64).astype(np.int32).astype(np.int64)
    dots = []
    for _ in range(4):
        limb = ((v + 128) & 255) - 128
        exact = np.einsum("irm,im->r", pi.astype(np.int64), limb)
        dots.append(exact.astype(np.int32).astype(np.int64))
        v = (v - limb) >> 8
    return _model_recombine(np.stack(dots, axis=1))


def _model_recombine(dots: np.ndarray):
    u = (1 << 64) - 1
    proj, fits = [], True
    for row in dots.tolist():
        acc = row[3] & u
        for k in (2, 1, 0):
            acc = ((acc << 8) + (row[k] & u)) & u
        hi, lo = acc >> 32, acc & 0xFFFFFFFF
        lo_s = lo - (1 << 32) if lo >> 31 else lo
        fits &= hi == (0xFFFFFFFF if lo_s < 0 else 0)
        proj.append(lo_s)
    return np.array(proj, np.int64), fits


def test_jl_recombine_on_wrapping_limb_dots():
    """Limb dots at the int32 ends: the recombination, ``fits`` and the low
    word as the JAX package's emulated i64 gives them."""
    ends = [-I32, I32 - 1, -1, 0, 1, 255, -256, 1 << 24, -(1 << 24)]
    rng = np.random.default_rng(3)
    dots = np.concatenate([rng.choice(ends, (200, 4)),
                           rng.integers(-I32, I32, (200, 4)),
                           np.array([[0, 0, 0, 0], [I32 - 1, 0, 0, 0],
                                     [0, 0, 0, -128], [-I32, -1, -1, -1]])])
    want, _ = _model_recombine(dots)
    got, _ = tprover.jl_recombine(torch.from_numpy(dots))
    np.testing.assert_array_equal(got.numpy(), want)
    for row in dots:
        _, want_fits = _model_recombine(row[None])
        _, got_fits = tprover.jl_recombine(torch.from_numpy(row[None]))
        assert got_fits == want_fits, row


def test_jl_projection_above_the_old_cap(monkeypatch):
    """4,194,432 coefficients (the port used to assert beyond 4,194,303),
    witness at +-(2^31 - 1) and the limb edges, 3 rows of pi, through many
    chunks: equal to the numpy model of the JAX arithmetic."""
    monkeypatch.setattr(tprover, "JL_CHUNK", 1 << 18)
    rng = np.random.default_rng(11)
    r, m = 2, (1 << 21) + 64
    pi = rng.integers(-1, 2, (r, 3, m)).astype(np.int8)
    w = rng.choice([-1, 1], (r, m)) * rng.integers(I32 - 4096, I32, (r, m))
    w[0, :len(EDGES)] = EDGES
    proj, fits = tprover.jl_projection(torch.from_numpy(pi),
                                       torch.from_numpy(w))
    want, want_fits = _model_projection(pi, w)
    np.testing.assert_array_equal(proj.numpy(), want)
    assert fits == want_fits


@pytest.mark.parametrize("limb_value,pi_value", [(-128, 1), (127, -1)])
def test_jl_limb_dots_wrap_int32(limb_value, pi_value):
    """Above 2^24 coefficients a limb dot leaves the int32 range; the JAX
    package's int32 dot wraps it, and so does the port.  pi and the
    witness are broadcast views of one value, so nothing large is
    allocated but the witness limbs."""
    n = (1 << 24) + (1 << 18)
    pi = torch.full((1, 1, 1), pi_value, dtype=torch.int8).expand(1, 2, n)
    w = torch.full((1, 1), limb_value, dtype=torch.int64).expand(1, n)
    dots = tprover.jl_limb_dots(pi, w)
    exact = n * limb_value * pi_value
    assert abs(exact) >= I32
    wrapped = (exact + I32) % (1 << 32) - I32
    # a value in [-128, 127] is its own low limb; the others are 0
    np.testing.assert_array_equal(dots.numpy(), [[wrapped, 0, 0, 0]] * 2)


# ---------------------------------------------------------------------------
# challenge rejection
# ---------------------------------------------------------------------------

def _draws(seed: int, count: int) -> np.ndarray:
    """Signed permutations of the challenge multiset (the sampler's sign
    rule: a positive coefficient is negated on a fair bit), (count, 64)."""
    rng = np.random.default_rng(seed)
    ms = jsampling._challenge_multiset(64).astype(np.int64)
    c = rng.permuted(np.tile(ms, (count, 1)), axis=1)
    signs = rng.integers(0, 2, c.shape).astype(bool)
    return np.where(signs & (c > 0), -c, c)


def _norms64(c: np.ndarray) -> np.ndarray:
    er, ei = jsampling._eval_matrices(64)
    cf = c.astype(np.float64)
    re, im = cf @ er.astype(np.float64), cf @ ei.astype(np.float64)
    return np.sqrt(np.max(re * re + im * im, axis=1))


def _jax_norms(c: np.ndarray) -> np.ndarray:
    """operator_norm_exact per draw, unbatched as the JAX prover and
    verifier call it (lax.map keeps the (64,) @ (64, 64) product)."""
    f = jax.jit(lambda cs: jax.lax.map(
        lambda x: jsampling.operator_norm_exact(x, 64), cs))
    return np.asarray(f(jnp.asarray(c, jnp.int32)))


def _port_rejected(c: np.ndarray) -> np.ndarray:
    return np.concatenate([tsampling.challenge_rejected(c[s:s + 10_000], 64)
                           for s in range(0, len(c), 10_000)])


def test_challenge_decision_equals_jax_on_1e5_draws():
    c = _draws(2026, 100_000)
    want = _jax_norms(c) > T_OPNORM
    np.testing.assert_array_equal(_port_rejected(c), want)
    assert 0.7 < want.mean() < 0.9


def test_challenge_decision_equals_jax_nearest_15():
    """The 50 draws of 10^6 whose exact norm lies nearest 15, against the
    lax.map form and against one jitted call per draw."""
    near = []
    for s in range(10):
        c = _draws(7000 + s, 100_000)
        gap = np.abs(_norms64(c) - T_OPNORM)
        idx = np.argsort(gap)[:50]
        near.append((gap[idx], c[idx]))
    gap = np.concatenate([g for g, _ in near])
    cs = np.concatenate([c for _, c in near])[np.argsort(gap)[:50]]
    assert np.sort(gap)[49] < 1e-3
    want = _jax_norms(cs) > T_OPNORM
    single = jax.jit(lambda x: jsampling.operator_norm_exact(x, 64))
    for i, c in enumerate(cs):
        assert bool(single(jnp.asarray(c, jnp.int32)) > T_OPNORM) == want[i]
    np.testing.assert_array_equal(_port_rejected(cs), want)
    assert 0 < want.sum() < len(want)

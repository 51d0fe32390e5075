"""Samplers: witness, challenge space, verifier randomness, JL matrices.

Counterpart of ``labrador_tpu/sampling.py``, drawing from the same key
streams (``keys``), so equal keys give equal draws.  The JAX rejection
``while_loop``s become bounded Python loops.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from . import keys, prg, zq
from .keys import Key
from .modmath import mod_pos, sum_sq_u64
from .params import LabradorParams, T_OPNORM

# Rejection loops of the JAX package have no iteration cap; these caps are
# far beyond any expected count (each halving is a factor 4 on the norm, a
# challenge draw is accepted with probability about 1/2).
_MAX_HALVINGS = 64
_MAX_CHALLENGE_DRAWS = 1000


def uniform_zq(key: Key, shape, q: int, device="cuda") -> torch.Tensor:
    """Uniform [0, q) from 64 random bits per entry (bias < q / 2**64):
    ``jax.random.bits(key, shape + (2,))`` reduced as (b0 * 2**32 + b1) mod q,
    at small and at big q."""
    b = keys.bits(key, tuple(shape) + (2,), device)
    return prg.words_mod_q(b[..., 0], b[..., 1], q)


def generate_witness(key: Key, params: LabradorParams,
                     device="cuda") -> torch.Tensor:
    """(r, n, d) witness with raw-residue squared norm <= beta^2: a uniform
    draw, halved as a whole until the bound holds (``sampling.py`` of the
    JAX package).  At big q the draw is first shifted right by
    q.bit_length() - 30 bits into the int32 range, as the JAX package does
    (beta << 2^30, so the shift is a prefix of the halvings)."""
    p = params
    w = uniform_zq(key, (p.r, p.n, p.d), p.q, device)
    if zq.is_big(p.q):
        w = w >> max(0, p.q.bit_length() - 30)
    bound = p.beta_bound * p.beta_bound
    count = p.r * p.n * p.d
    elem_cap = min(math.isqrt((1 << 63) // count), 2**30)
    for _ in range(_MAX_HALVINGS):
        # phase 1 (any element above elem_cap) then phase 2 (exact norm)
        if int(torch.max(w)) <= elem_cap and sum_sq_u64(w) <= bound:
            return w
        w = torch.div(w, 2, rounding_mode="floor")
    raise RuntimeError("witness halving did not converge")


# ---------------------------------------------------------------------------
# Challenge space (reference verification.rs:460-489, util.rs:83-104)
# ---------------------------------------------------------------------------

def _challenge_multiset(d: int) -> torch.Tensor:
    if d == 64:
        # 23 zeros, 31 ones, 10 twos: ||c||^2 = 71 = TAU
        return torch.tensor([0] * 23 + [1] * 31 + [2] * 10, dtype=torch.int64)
    base = [1, 0] * ((d + 1) // 2)
    return torch.tensor(base[:d], dtype=torch.int64)


@lru_cache(maxsize=None)
def _eval_matrices(d: int) -> np.ndarray:
    """cos | sin of the (d, d) evaluation at the primitive 2d-th roots, as
    the JAX package builds them (float64 angles rounded to float32), side
    by side: (d, 2d) float32, the real part's columns first."""
    j = np.arange(d)[:, None]
    k = np.arange(d)[None, :]
    ang = np.pi * (2 * k + 1) * j / d
    return np.concatenate([np.cos(ang), np.sin(ang)],
                          axis=1).astype(np.float32)


# XLA on the CPU takes the float32 (d,) @ (d, d) product of the JAX
# package's ``operator_norm_exact`` as 8 partial sums, lane a over the
# coefficients j = a mod 8 in increasing j, combined pairwise
# ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)), and contracts
# re*re + im*im into one fused multiply-add, fma(re, re, im*im).  The
# port evaluates the same operations in the same order, on the host.
_LANES = 8


def _fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Correctly rounded float32 a*b + c for float32 arrays (one rounding,
    as a fused multiply-add): a*b is exact in float64, the float64 sum
    carries its exact error (TwoSum), and that error decides the one case
    where rounding the float64 sum to float32 can differ, a float64 sum
    that falls exactly halfway between two float32 values."""
    x, y = a.astype(np.float64) * b, c.astype(np.float64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    r = s.astype(np.float32)
    r2 = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(np.float32))
    mid = (s != r) & (s == (r.astype(np.float64) + r2) / 2)
    return np.where(mid & (err > 0), np.maximum(r, r2),
                    np.where(mid & (err < 0), np.minimum(r, r2), r))


def operator_norm_sq(c_centered, d: int) -> np.ndarray:
    """Squared exact operator norm of multiplication by c, max_k
    |c(omega^(2k+1))|^2, in float32 as the JAX package's
    ``operator_norm_exact`` computes it on the CPU (the order above).
    c_centered (..., d) integers (a tensor or an array); returns (...)
    float32, computed on the host whatever the tensor's device."""
    if isinstance(c_centered, torch.Tensor):
        c_centered = c_centered.cpu().numpy()
    cf = np.asarray(c_centered).astype(np.float32)
    lead = cf.shape[:-1]
    lanes = min(_LANES, d)
    assert d % lanes == 0 and lanes & (lanes - 1) == 0, d
    cf = cf.reshape(lead + (d // lanes, lanes, 1))
    m = _eval_matrices(d).reshape(d // lanes, lanes, 2 * d)
    acc = cf[..., 0, :, :] * m[0]
    for s in range(1, d // lanes):
        acc = acc + cf[..., s, :, :] * m[s]       # (..., lanes, 2d)
    while acc.shape[-2] > 1:
        acc = acc[..., 0::2, :] + acc[..., 1::2, :]
    re, im = acc[..., 0, :d], acc[..., 0, d:]
    return np.max(_fma_f32(re, re, im * im), axis=-1)


def challenge_rejected(c_centered, d: int) -> np.ndarray:
    """The JAX package's rejection decision, sqrt(max(re^2 + im^2)) > T in
    float32, for (..., d) centred polynomials.  For a float32 x >= 0 the
    correctly rounded sqrt(x) exceeds T = 15 iff x > 225: the float32 just
    above 15 is 15 + 2^-20, the halfway point rounds to 15 (even), and
    (15 + 2^-21)^2 lies between 225 and the next float32, 225 + 2^-16.  So
    the decision needs no sqrt, whose float32 rounding torch's CPU kernel
    does not guarantee."""
    assert T_OPNORM == 15
    return operator_norm_sq(c_centered, d) > np.float32(225)


def _draw_challenges(ks: list, d: int) -> torch.Tensor:
    """(len(ks), d) centred challenge draws, one a key, each a signed
    permutation of the fixed multiset (the JAX package's ``draw``); the
    draws of Threefry keys run as one batch of host tensor ops."""
    kp, kb = zip(*keys.split_stack(list(ks)))
    perm = keys.permutation_stack(list(kp), _challenge_multiset(d))
    signs = keys.bernoulli_stack(list(kb), 0.5, (d,), device="cpu")
    return torch.where(signs & (perm > 0), -perm, perm)


def sample_challenges(ks: list, params: LabradorParams,
                      device="cuda") -> torch.Tensor:
    """(len(ks), d): ``sample_challenge`` of each key, as
    ``jax.vmap(sample_challenge)`` runs its rejection ``while_loop`` in
    lockstep: every key follows its own chain, fold_in(k, 0) and then
    fold_in(., 1) per redraw, each round redraws only the keys still
    rejected (an accepted challenge keeps its value), and one batched
    float32 evaluation decides the round.  So each row equals the
    single-key draw bit for bit.  Residues mod q at small q, signed at big
    q (the JAX package's convention there)."""
    p = params
    cur = keys.fold_in_stack(list(ks), 0)
    centered = _draw_challenges(cur, p.d) if cur else \
        torch.zeros((0, p.d), dtype=torch.int64)
    todo = list(range(len(cur)))
    for _ in range(_MAX_CHALLENGE_DRAWS):
        rejected = challenge_rejected(centered[todo], p.d)
        todo = [i for i, rej in zip(todo, rejected) if rej]
        if not todo:
            if zq.is_big(p.q):
                return centered.to(device)
            return mod_pos(centered, p.q).to(device)
        redraw = keys.fold_in_stack([cur[i] for i in todo], 1)
        for i, k in zip(todo, redraw):
            cur[i] = k
        centered[todo] = _draw_challenges(redraw, p.d)
    raise RuntimeError("challenge rejection did not terminate")


# ---------------------------------------------------------------------------
# Verifier scalar/poly randomness (verification.rs:441-513)
# ---------------------------------------------------------------------------

def sample_psi(key: Key, params: LabradorParams,
               device="cuda") -> torch.Tensor:
    """(L,) uniform Zq (``generate_psi``)."""
    return uniform_zq(key, (params.l_count,), params.q, device)


def sample_omega(key: Key, params: LabradorParams,
                 device="cuda") -> torch.Tensor:
    """(256,) uniform Zq (``generate_omega``)."""
    return uniform_zq(key, (256,), params.q, device)


def sample_alpha(key: Key, params: LabradorParams,
                 device="cuda") -> torch.Tensor:
    """(K, d) uniform ring elements (``fetch_alpha``)."""
    return uniform_zq(key, (params.k_count, params.d), params.q, device)


def sample_beta(key: Key, params: LabradorParams,
                device="cuda") -> torch.Tensor:
    """(upper_bound, d) uniform ring elements (``fetch_beta``)."""
    return uniform_zq(key, (params.upper_bound, params.d), params.q, device)


def sample_jl_matrices(ks: list, params: LabradorParams,
                       device="cuda") -> torch.Tensor:
    """(len(ks), 256, n*d) ternary int8 matrices, one per key, drawn in one
    batch: two random bits b0, b1 -> b0 + b1 - 1 (P(-1) = P(+1) = 1/4)."""
    b = keys.bits_stack(ks, (256, params.n * params.d), device)
    return ((b & 1) + ((b >> 1) & 1) - 1).to(torch.int8)

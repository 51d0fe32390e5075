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

from . import keys
from .keys import Key
from .ops import prg, zq
from .ops.modmath import mod_pos, sum_sq_u64
from .params import LabradorParams, T_OPNORM

# Rejection loops of the JAX package have no iteration cap; these caps are
# far beyond any expected count (each halving is a factor 4 on the norm, a
# challenge draw is accepted with probability about 1/2).
_MAX_HALVINGS = 64
_MAX_CHALLENGE_DRAWS = 1000


def uniform_zq(key: Key, shape, q: int, device=None) -> torch.Tensor:
    """Uniform [0, q) from 64 random bits per entry (bias < q / 2**64):
    ``jax.random.bits(key, shape + (2,))`` reduced as (b0 * 2**32 + b1) mod q."""
    if zq.is_big(q):
        raise NotImplementedError("big-q sampling belongs to the big-q slice")
    b = keys.bits(key, tuple(shape) + (2,), device)
    return prg.words_mod_q(b[..., 0], b[..., 1], q)


def generate_witness(key: Key, params: LabradorParams,
                     device=None) -> torch.Tensor:
    """(r, n, d) witness with raw-residue squared norm <= beta^2: a uniform
    draw, halved as a whole until the bound holds (``sampling.py`` of the
    JAX package)."""
    p = params
    w = uniform_zq(key, (p.r, p.n, p.d), p.q, device)
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
def _eval_matrices(d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of the (d, d) evaluation at the primitive 2d-th roots, as the
    JAX package builds them (float64 angles rounded to float32)."""
    j = np.arange(d)[:, None]
    k = np.arange(d)[None, :]
    ang = np.pi * (2 * k + 1) * j / d
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


def operator_norm_sq(c_centered: torch.Tensor, d: int) -> float:
    """Squared exact operator norm of multiplication by c: max_k
    |c(omega^(2k+1))|^2.  Evaluated in float64 from the JAX package's
    float32 tables; the JAX package evaluates in float32, so the two
    rejection decisions can differ only for a norm within float32 rounding
    of T (the parity tests check the margin of every draw they compare)."""
    er, ei = _eval_matrices(d)
    cf = c_centered.to(torch.float64).cpu()
    re = cf @ er.to(torch.float64)
    im = cf @ ei.to(torch.float64)
    return float(torch.max(re * re + im * im))


def _draw_challenge(key: Key, d: int) -> torch.Tensor:
    kp, ks = keys.split(key)
    perm = keys.permutation(kp, _challenge_multiset(d))
    signs = keys.bernoulli(ks, 0.5, (d,))
    return torch.where(signs & (perm > 0), -perm, perm)


def sample_challenge(key: Key, params: LabradorParams,
                     device=None) -> torch.Tensor:
    """One challenge polynomial: a signed permutation of the fixed multiset,
    redrawn (key folded with 1) while its operator norm exceeds T = 15.
    Drawn on the host (64 values) and returned as residues mod q."""
    p = params
    k = keys.fold_in(key, 0)
    centered = _draw_challenge(k, p.d)
    for _ in range(_MAX_CHALLENGE_DRAWS):
        if operator_norm_sq(centered, p.d) <= T_OPNORM * T_OPNORM:
            return mod_pos(centered, p.q).to(device)
        k = keys.fold_in(k, 1)
        centered = _draw_challenge(k, p.d)
    raise RuntimeError("challenge rejection did not terminate")


# ---------------------------------------------------------------------------
# Verifier scalar/poly randomness (verification.rs:441-513)
# ---------------------------------------------------------------------------

def sample_psi(key: Key, params: LabradorParams, device=None) -> torch.Tensor:
    """(L,) uniform Zq (``generate_psi``)."""
    return uniform_zq(key, (params.l_count,), params.q, device)


def sample_omega(key: Key, params: LabradorParams,
                 device=None) -> torch.Tensor:
    """(256,) uniform Zq (``generate_omega``)."""
    return uniform_zq(key, (256,), params.q, device)


def sample_alpha(key: Key, params: LabradorParams,
                 device=None) -> torch.Tensor:
    """(K, d) uniform ring elements (``fetch_alpha``)."""
    return uniform_zq(key, (params.k_count, params.d), params.q, device)


def sample_beta(key: Key, params: LabradorParams,
                device=None) -> torch.Tensor:
    """(upper_bound, d) uniform ring elements (``fetch_beta``)."""
    return uniform_zq(key, (params.upper_bound, params.d), params.q, device)


def sample_jl_matrix(key: Key, params: LabradorParams,
                     device=None) -> torch.Tensor:
    """(256, n*d) ternary int8 matrix: two random bits b0, b1 -> b0 + b1 - 1
    (P(-1) = P(+1) = 1/4)."""
    b = keys.bits(key, (256, params.n * params.d), device)
    return ((b & 1) + ((b >> 1) & 1) - 1).to(torch.int8)

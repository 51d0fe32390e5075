"""Negacyclic NTT over Rq = Zq[X]/(X^d + 1) via a CRT over small primes.

Counterpart of ``labrador_tpu/ops/ntt.py``: q = 8191 is not NTT-friendly,
so products are computed exactly over the integers in the evaluation domain
of internal primes p = 1 (mod 2d), p < 2**15, and reconstructed mod q by
Garner.  Each transform is a (batch, d) @ (d, d) product per prime
(``modmath.matmul_mod``, exact in float64).

Layout (kept from the JAX package so tests compare like with like):
evaluation-domain tensors are ``(P, ..., d)``; coefficient-domain tensors
are ``(..., d)`` int64 residues in [0, q).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..params import LabradorParams, select_crt_primes
from .modmath import P_MAX, matmul_mod, mod_pos, per_prime
from .zq import fold_res_modq, to_res


def _primitive_root(p: int) -> int:
    factors = []
    n = p - 1
    f = 2
    while f * f <= n:
        if n % f == 0:
            factors.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {p}")


@dataclass(frozen=True, eq=False)
class NttPlan:
    """Transform + CRT tables for (q, d, primes); the same numpy tables as
    ``labrador_tpu.ops.ntt.NttPlan``.  Device copies are cached per device
    on the plan (plans are lru_cached singletons)."""

    q: int
    d: int
    primes: tuple[int, ...]
    V: np.ndarray            # (P, d, d) forward: xhat = x @ V[p]
    W: np.ndarray            # (P, d, d) inverse: x = xhat @ W[p]
    garner_inv: np.ndarray   # (P, P) inv(p_j) mod p_k for j < k
    m_half_digits: tuple[int, ...]
    prefix_mod_q: tuple[int, ...]
    m_mod_q: int
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def n_primes(self) -> int:
        return len(self.primes)

    def tensors(self, device) -> dict:
        """{'pv': (P,) primes, 'V', 'W': (P, d, d)} as int64 on ``device``."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {
                "pv": torch.tensor(self.primes, dtype=torch.int64,
                                   device=device),
                "V": torch.as_tensor(self.V, dtype=torch.int64).to(device),
                "W": torch.as_tensor(self.W, dtype=torch.int64).to(device),
            }
        return self._dev[device]

    def pv(self, device, ndim: int) -> torch.Tensor:
        """Primes shaped (P, 1, ..., 1) to broadcast down a rank-ndim tensor."""
        return per_prime(self.tensors(device)["pv"], ndim)


@lru_cache(maxsize=None)
def make_plan(q: int, d: int = 64, max_accum: int = 1 << 20) -> NttPlan:
    """``labrador_tpu.ops.ntt.make_plan`` at small q."""
    if q > P_MAX:
        raise NotImplementedError(
            f"q={q} > {P_MAX} needs two-limb residues: the big-q slice of the "
            "port")
    primes = select_crt_primes(q, d, max_accum)
    P = len(primes)
    V = np.zeros((P, d, d), np.int64)
    W = np.zeros((P, d, d), np.int64)
    for pi, p in enumerate(primes):
        g = _primitive_root(p)
        phi = pow(g, (p - 1) // (2 * d), p)
        assert pow(phi, d, p) == p - 1, "phi must be a 2d-th root with phi^d=-1"
        d_inv = pow(d, p - 2, p)
        for j in range(d):
            for k in range(d):
                V[pi, j, k] = pow(phi, ((2 * k + 1) * j) % (2 * d), p)
                W[pi, k, j] = d_inv * pow(phi, (-(2 * k + 1) * j) % (2 * d),
                                          p) % p
    ginv = np.zeros((P, P), np.int64)
    for k in range(P):
        for j in range(k):
            ginv[j, k] = pow(primes[j], primes[k] - 2, primes[k])
    M = 1
    for p in primes:
        M *= p
    mh = M // 2
    mh_digits = []
    for p in primes:
        mh_digits.append(mh % p)
        mh //= p
    prefix = []
    acc = 1
    for p in primes:
        prefix.append(acc % q)
        acc *= p
    return NttPlan(q=q, d=d, primes=primes, V=V, W=W, garner_inv=ginv,
                   m_half_digits=tuple(mh_digits), prefix_mod_q=tuple(prefix),
                   m_mod_q=M % q)


@lru_cache(maxsize=None)
def plan_for(params: LabradorParams) -> NttPlan:
    """``labrador_tpu.ops.ntt.plan_for``: CRT headroom for the kappa-sized
    and k_count-sized eval-domain contractions."""
    return make_plan(params.q, params.d,
                     max_accum=max(2 * params.kappa, 2 * params.k_count,
                                   1024))


def _p_max(plan: NttPlan) -> int:
    return max(plan.primes)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def ntt_fwd(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Coefficient domain (..., d) -> eval domain (P, ..., d).  Accepts
    residues in [0, q) or small signed values (digits, challenges)."""
    shape = tuple(x.shape)
    res = to_res(x.reshape(-1, plan.d), plan)                  # (P, B, d)
    t = plan.tensors(x.device)
    pm = _p_max(plan)
    out = matmul_mod(res, t["V"], plan.pv(x.device, 3), pm, pm)
    return out.reshape((plan.n_primes,) + shape)


def ntt_inv_modq(xhat: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Eval domain (P, ..., d) -> coefficient domain (..., d) in [0, q)."""
    shape = tuple(xhat.shape[1:])
    t = plan.tensors(xhat.device)
    pm = _p_max(plan)
    r = matmul_mod(xhat.reshape(plan.n_primes, -1, plan.d), t["W"],
                   plan.pv(xhat.device, 3), pm, pm)
    return fold_res_modq(r.reshape((plan.n_primes,) + shape), plan,
                         signed=True)


# ---------------------------------------------------------------------------
# Ring ops in the evaluation domain
# ---------------------------------------------------------------------------

def _mod_p(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    return mod_pos(x, plan.pv(x.device, x.ndim))


def eval_mul(ahat: torch.Tensor, bhat: torch.Tensor,
             plan: NttPlan) -> torch.Tensor:
    """Pointwise product; trailing dims broadcast after the prime axis."""
    nd = max(ahat.ndim, bhat.ndim)
    a = ahat.reshape(ahat.shape[:1] + (1,) * (nd - ahat.ndim) + ahat.shape[1:])
    b = bhat.reshape(bhat.shape[:1] + (1,) * (nd - bhat.ndim) + bhat.shape[1:])
    return _mod_p(a * b, plan)


def eval_add(a: torch.Tensor, b: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    return _mod_p(a + b, plan)


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor,
                       plan: NttPlan) -> torch.Tensor:
    """Exact (a * b) in Rq for coefficient tensors (..., d); broadcasts."""
    return ntt_inv_modq(eval_mul(ntt_fwd(a, plan), ntt_fwd(b, plan), plan),
                        plan)


def eval_matmul(ahat: torch.Tensor, bhat: torch.Tensor,
                plan: NttPlan) -> torch.Tensor:
    """Ring-matrix product in the eval domain:
    (P, M, K, d) x (P, K, N, d) -> (P, M, N, d)."""
    a = torch.movedim(ahat, -1, 1)              # (P, d, M, K)
    b = torch.movedim(bhat, -1, 1)              # (P, d, K, N)
    pm = _p_max(plan)
    o = matmul_mod(a, b, plan.pv(ahat.device, 4), pm, pm)
    return torch.movedim(o, 1, -1)


def _mod_sum_p(x: torch.Tensor, plan: NttPlan, axis: int) -> torch.Tensor:
    """Sum mod p along ``axis`` (not the prime axis) of residues in [0, p):
    int64 partial sums stay exact for fewer than 2**48 terms."""
    ax = axis % x.ndim
    assert ax != 0, "cannot sum over the prime axis"
    assert x.shape[ax] < (1 << 48)
    s = torch.sum(x, dim=ax)
    return _mod_p(s, plan)


def polyvec_inner_product(a: torch.Tensor, b: torch.Tensor, plan: NttPlan,
                          axis: int = -2) -> torch.Tensor:
    """sum_i a_i * b_i for vectors of ring elements (..., m, d)."""
    prod = eval_mul(ntt_fwd(a, plan), ntt_fwd(b, plan), plan)
    return ntt_inv_modq(_mod_sum_p(prod, plan, axis=axis), plan)

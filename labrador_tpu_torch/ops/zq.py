"""Canonical Zq residues at small q, and the CRT boundary.

Counterpart of the single-limb half of ``labrador_tpu/ops/zq.py``.  At
small q a residue tensor is a plain int64 tensor, so the JAX package's
structural helpers (``reshape``, ``moveaxis``, ``tmap`` ...), which exist to
treat the two-limb big-q representation alike, are the tensor methods
themselves; the big-q representation belongs to a later slice.
"""

from __future__ import annotations

import torch

from .modmath import P_MAX, mod_pos


def is_big(q: int) -> bool:
    return q > P_MAX


def add(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    return mod_pos(a + b, q)


def to_signed_small(x: torch.Tensor, q: int) -> torch.Tensor:
    """Residues in [0, q) -> centred representatives in (-q/2, q/2]."""
    return torch.where(x > q // 2, x - q, x)


def all_eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a, b))


def to_res(x: torch.Tensor, plan) -> torch.Tensor:
    """Residues of (possibly signed) integers mod each prime: (P, ...)."""
    return mod_pos(x.unsqueeze(0), plan.pv(x.device, x.ndim + 1))


def fold_res_modq(res: torch.Tensor, plan, signed: bool = True) -> torch.Tensor:
    """Per-prime residues (P, ...) of an integer |X| < M/2 (signed) or
    0 <= X < M -> X mod q, by mixed-radix (Garner) digits."""
    q = plan.q
    primes = plan.primes
    v = [res[0]]
    for k in range(1, len(primes)):
        p = primes[k]
        t = mod_pos(res[k] - v[0], p)
        for j in range(1, k):
            t = mod_pos(t * int(plan.garner_inv[j - 1, k]), p)
            t = mod_pos(t - v[j], p)
        v.append(mod_pos(t * int(plan.garner_inv[k - 1, k]), p))
    out = torch.zeros_like(v[0])
    for j, vj in enumerate(v):
        out = out + mod_pos(vj * plan.prefix_mod_q[j], q)
    if signed:
        # lexicographic compare (most significant digit last) with floor(M/2)
        gt = torch.zeros(v[0].shape, dtype=torch.bool, device=v[0].device)
        for j, vj in enumerate(v):
            mj = plan.m_half_digits[j]
            gt = (vj > mj) | ((vj == mj) & gt)
        out = out - gt.to(torch.int64) * plan.m_mod_q
    return mod_pos(out, q)

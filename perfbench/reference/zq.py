"""Canonical Zq residues, the CRT boundary, and big-q digit extraction.

Counterpart of ``labrador_tpu/ops/zq.py``.  The JAX package keeps small-q
residues as int32 and big-q residues (2^32 < q < 2^33) as two-limb
``Zq2(hi, lo)`` int32 pairs, because the TPU has no 64-bit integers.  Here
a residue tensor is one int64 tensor in [0, q) at any q (q < 2^33), so the
helpers that exist to treat the two representations alike (``zeros``,
``stack``, ``reshape``, ``swapaxes``, ``index``, ``tmap``, ``from_words32``
...) are the torch functions, tensor methods and indexing themselves, and
``from_signed`` is ``mod_pos``.  What int64 does not make free is kept:
products of two residues go through ``modmath.mulmod``, and the Garner
fold below keeps every term below 2^51 at the big-q prime count (P = 6).

Small-valued tensors follow the JAX package's conventions: at big q the
digits of ``decompose_balanced_big`` and the challenges are signed, not
lifted mod q.
"""

from __future__ import annotations

import torch

from .modmath import P_MAX, mod_pos


def is_big(q: int) -> bool:
    return q > P_MAX


def add(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    return mod_pos(a + b, q)


def sub(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    return mod_pos(a - b, q)


def to_signed_small(x: torch.Tensor, q: int) -> torch.Tensor:
    """Residues in [0, q) -> centred representatives in (-q/2, q/2]; signed
    inputs with |x| <= q/2 pass unchanged."""
    return torch.where(x > q // 2, x - q, x)


def all_eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a, b))


def to_res(x: torch.Tensor, plan) -> torch.Tensor:
    """Residues of (possibly signed) integers mod each prime: (P, ...)."""
    return mod_pos(x.unsqueeze(0), plan.pv(x.device, x.ndim + 1))


def fold_res_modq(res: torch.Tensor, plan, signed: bool = True) -> torch.Tensor:
    """Per-prime residues (P, ...) of an integer |X| < M/2 (signed) or
    0 <= X < M -> X mod q, by mixed-radix (Garner) digits.  Every term
    v_j * (prod_{i<j} p_i mod q) is below 2^15 * q < 2^48 and the P of them
    sum below 2^51 for P <= 8, so the fold is exact in int64 at big q."""
    q = plan.q
    primes = plan.primes
    assert len(primes) <= 8, "Garner terms would leave the int64 range"
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
        out = out + vj * plan.prefix_mod_q[j]
    if signed:
        # lexicographic compare (most significant digit last) with floor(M/2)
        gt = torch.zeros(v[0].shape, dtype=torch.bool, device=v[0].device)
        for j, vj in enumerate(v):
            mj = plan.m_half_digits[j]
            gt = (vj > mj) | ((vj == mj) & gt)
        out = out - gt.to(torch.int64) * plan.m_mod_q
    return mod_pos(out, q)


def decompose_balanced_big(x: torch.Tensor, base: int, ndigits: int,
                           q: int) -> torch.Tensor:
    """``labrador_tpu.ops.zq.decompose_balanced_big``: signed balanced
    base-b digits in [-b/2, b/2] of the centred representative of x mod q,
    taken as sign times the digits of its magnitude (so an even base's
    digit b/2 keeps the value's sign), (ndigits, *x.shape) int64.
    sum_k d_k b^k == x (mod q) when b^ndigits covers [0, q)."""
    b = int(base)
    half_b = b // 2
    xc = to_signed_small(mod_pos(x, q), q)
    sign = torch.where(xc < 0, -1, 1)
    m = torch.abs(xc)
    digits = []
    for _ in range(int(ndigits)):
        r = torch.remainder(m, b)
        adj = r > half_b
        digits.append(torch.where(adj, r - b, r))
        m = torch.div(m, b, rounding_mode="floor") + adj.to(torch.int64)
    return torch.stack(digits, dim=0) * sign

"""Exact modular arithmetic on int64 tensors.

Counterpart of ``labrador_tpu/ops/modmath.py``.  The TPU package keeps every
intermediate inside int32 (float-Barrett reductions, int8 limb dots,
emulated u64 pairs) because the TPU has no 64-bit integers.  Here residues
are int64 and the reductions are plain ``torch.remainder``; what must stay
exact is said next to each function:

* ``matmul_mod`` contracts in float64, which is exact while every partial
  sum stays below 2**53 (CUDA has no integer ``matmul``); the contraction is
  chunked so that bound holds and is asserted.
* ``u64_sum`` / ``sum_sq_u64`` keep the JAX contract (exact sum, wrapping
  mod 2**64) by summing 31-bit halves in int64 and returning Python ints.
"""

from __future__ import annotations

import torch

# Largest single-limb modulus of the JAX package (``labrador_tpu.ops.modmath``):
# the small-q slice ported here covers q <= P_MAX, every CRT prime is below it.
P_MAX = 32513

F64_EXACT = 1 << 53
_U64 = (1 << 64) - 1
_HALF_BITS = 31
_HALF_MASK = (1 << _HALF_BITS) - 1


def mod_pos(x: torch.Tensor, m) -> torch.Tensor:
    """x mod m in [0, m).  ``m`` is a Python int or an int64 tensor that
    broadcasts against x (a per-prime modulus vector is passed already shaped
    (P, 1, ..., 1) by ``per_prime``)."""
    return torch.remainder(x, m)


def per_prime(pv: torch.Tensor, ndim: int) -> torch.Tensor:
    """(P,) modulus vector -> (P, 1, ..., 1) of rank ndim."""
    return pv.reshape((pv.shape[0],) + (1,) * (ndim - 1))


def matmul_mod(a: torch.Tensor, b: torch.Tensor, m, a_max: int,
               b_max: int) -> torch.Tensor:
    """Exact (a @ b) mod m for int64 tensors with |a| <= a_max, |b| <= b_max.

    Batched like ``torch.matmul``.  The contraction runs in float64 in
    chunks of at most (2**53 - 1) // (a_max * b_max) terms, so every partial
    sum is an integer below 2**53 and the float result is exact whatever the
    summation order; chunks are reduced mod m and added in int64."""
    k = a.shape[-1]
    per = max(1, a_max * b_max)
    chunk = (F64_EXACT - 1) // per
    assert chunk >= 1, "operand bounds exceed the float64 exact range"
    acc = None
    for c0 in range(0, k, chunk):
        c1 = min(k, c0 + chunk)
        part = torch.matmul(a[..., c0:c1].to(torch.float64),
                            b[..., c0:c1, :].to(torch.float64))
        part = mod_pos(part.to(torch.int64), m)
        acc = part if acc is None else mod_pos(acc + part, m)
    return acc


def matmul_exact(a: torch.Tensor, b: torch.Tensor, a_max: int,
                 b_max: int) -> torch.Tensor:
    """Exact integer a @ b (int64) for |a| <= a_max, |b| <= b_max whose
    whole contraction stays below 2**53 (asserted)."""
    assert a.shape[-1] * a_max * b_max < F64_EXACT, \
        "contraction exceeds the float64 exact range"
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int64)


def u64_sum(x: torch.Tensor) -> int:
    """Sum of nonnegative int64 values below 2**62, as a Python int mod
    2**64 (the JAX ``u64_sum`` contract).  The 31-bit halves are summed
    separately, each sum asserted below 2**63."""
    x = x.reshape(-1).to(torch.int64)
    if x.numel() == 0:
        return 0
    assert x.numel() < (1 << 32), "too many terms for the int64 half sums"
    lo = int(torch.sum(x & _HALF_MASK))
    hi = int(torch.sum(x >> _HALF_BITS))
    return ((hi << _HALF_BITS) + lo) & _U64


def sum_sq_u64(x: torch.Tensor) -> int:
    """Exact sum of squares of int64 values of magnitude below 2**31, as a
    Python int mod 2**64 (the JAX ``sum_sq_u64`` contract)."""
    a = torch.abs(x.reshape(-1).to(torch.int64))
    return u64_sum(a * a)


def to_signed_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values into the int32 range (the low
    word the JAX package keeps of an emulated i64)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)

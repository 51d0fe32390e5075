"""Base-b gadget decomposition of ring elements.

Counterpart of ``labrador_tpu/ops/decompose.py``, both modes:

* ``reference`` — the reference's digit rule bit for bit, including the
  quirky ``centered_rep`` (``util.rs:377-387``): a digit d0 = c mod b above
  b/2 is stored as the positive b - d0 and the value continues from
  floor((c - (b - d0)) / b).  Lossy, but prover and verifier share it.
* ``exact`` — balanced signed digits that reconstruct c = sum d_k b^k.
"""

from __future__ import annotations

import torch

from .modmath import mod_pos


def decompose(x: torch.Tensor, base: int, ndigits: int,
              mode: str = "reference") -> torch.Tensor:
    """(ndigits, *x.shape) int64 digits of x (fixed-length truncation, as
    the reference's consumer keeps the first ``ndigits``)."""
    b = int(base)
    half = b // 2
    c = x.to(torch.int64)
    digits = []
    for _ in range(int(ndigits)):
        d0 = torch.remainder(c, b)
        if mode == "reference":
            dig = torch.where(d0 > half, b - d0, d0)
        elif mode == "exact":
            dig = torch.where(d0 > half, d0 - b, d0)
            if b % 2 == 0:
                # even base: pick the sign of the redundant digit b/2 so the
                # residual shrinks toward 0 (see the JAX module)
                dig = torch.where((d0 == half) & (c < 0), d0 - b, dig)
        else:
            raise ValueError(f"unknown decompose mode {mode!r}")
        digits.append(dig)
        c = torch.div(c - dig, b, rounding_mode="floor")
    return torch.stack(digits, dim=0)


def reconstruct(digits: torch.Tensor, base: int, q: int) -> torch.Tensor:
    """sum_k digits[k] * base^k mod q (exact mode reconstructs; reference
    mode generally does not — the documented quirk)."""
    out = torch.zeros(digits.shape[1:], dtype=torch.int64,
                      device=digits.device)
    weight = 1
    for k in range(digits.shape[0]):
        out = mod_pos(out + digits[k] * (weight % q), q)
        weight *= base
    return out

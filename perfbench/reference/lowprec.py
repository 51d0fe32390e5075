"""The control's arithmetic: the reference one precision below its own.

The configurations state exact residues mod q ~ 2^32 in 64-bit integers.
The nearest precision below is float64's 53-bit mantissa:
``mulmod_f64`` takes each product of two residues in float64 (products
reach 2^66), the step a later change might take for speed.
``lower_precision()`` puts it in place of ``modmath.mulmod`` for the
reference's own calls, which all go through the module.
"""

from __future__ import annotations

import contextlib

import torch

from . import modmath


def mulmod_f64(x: torch.Tensor, y, q: int) -> torch.Tensor:
    """x * y mod q with the product rounded to float64."""
    yf = y.to(torch.float64) if isinstance(y, torch.Tensor) else float(y)
    prod = x.to(torch.float64) * yf
    return torch.remainder(prod, float(q)).to(torch.int64) % q


@contextlib.contextmanager
def lower_precision():
    saved = modmath.mulmod
    modmath.mulmod = mulmod_f64
    try:
        yield
    finally:
        modmath.mulmod = saved

"""Ring operations on Rq = Zq[X]/(X^d + 1) coefficient tensors (..., d).

Counterpart of ``labrador_tpu/ops/rq.py`` (the subset the interactive path
uses; multiplication lives in ``ops.ntt``)."""

from __future__ import annotations

import torch

from .modmath import mod_pos


def sigma_inv(a: torch.Tensor, q: int) -> torch.Tensor:
    """Conjugation automorphism X^n -> -X^(d-n), constant term fixed
    (reference ``util.rs:118-137``)."""
    rolled = torch.roll(torch.flip(a, dims=(-1,)), 1, dims=-1)  # a[d-j]
    out = mod_pos(-rolled, q)
    out[..., 0] = a[..., 0]
    return out

"""The seeded virtual Threefry CRS: entries at global 64-bit offsets.

The reference's offset layout (``structs.rs:55-144``) with its two quirks:

* the B-matrix stride ``(i*t_1 + k) * kappa_1 * kappa`` has no factor d
  (``structs.rs:82``);
* the C/D column offsets multiply the triangle index by t_1, also for C,
  which has t_2 digits (``structs.rs:106``).

Matrix shapes (coefficient domain, int64 residues in [0, q)):
  A      : (kappa, n, d)
  B_ik   : (kappa_1, kappa, d)  for i < r, k < t_1
  C_ijk  : (kappa_2, d)         for i <= j < r, k < t_2
  D_ijk  : (kappa_2, d)         for i <= j < r, k < t_1
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import prg
from .params import LabradorParams


@dataclass(frozen=True)
class CRS:
    """``key`` is the (k0, k1) uint32 word pair of the Threefry key."""

    key: tuple[int, int]
    params: LabradorParams

    @classmethod
    def create(cls, params: LabradorParams, seed: int) -> "CRS":
        return cls(key=((seed >> 32) & prg.M32, seed & prg.M32),
                   params=params)

    @property
    def _off_b(self) -> int:
        p = self.params
        return p.kappa * p.n * p.d                      # structs.rs:78

    @property
    def _off_c(self) -> int:
        p = self.params
        return self._off_b + p.r * p.t_1 * p.kappa_1 * p.kappa * p.d

    @property
    def _off_d(self) -> int:
        p = self.params
        return self._off_c + p.r * (p.r + 1) // 2 * (p.kappa_2 * p.d)

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        """CRS entries at int64 ``offsets`` (any shape): Threefry."""
        return prg.uniform_mod_q(self.key[0], self.key[1], offsets,
                                 self.params.q)

    def expand(self, start: int, shape, strides, device) -> torch.Tensor:
        """Strided tile: offset[i0, i1, ...] = start + sum_k i_k *
        strides[k]."""
        return self.draw(prg.offset_iota(start, shape, strides, device))

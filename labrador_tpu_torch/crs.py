"""Common Reference String: a virtual, lazily expanded random oracle.

Counterpart of ``labrador_tpu/crs.py`` (the Threefry ``CRS``; the
ChaCha-compatible ``MaterializedCRS`` belongs to a later slice).  Entries
are defined positionally by a global 64-bit offset from the seed, in the
reference's layout (``structs.rs:55-144``) with its two quirks kept:

* the B-matrix stride ``(i*t_1 + k) * kappa_1 * kappa`` has no factor d
  (``structs.rs:82``);
* the C/D column offsets multiply the triangle index by t_1, also for C,
  which has t_2 digits (``structs.rs:106``).

Matrix shapes (coefficient domain, int64 residues in [0, q)):
  A      : (kappa, n, d)
  B_ik   : (kappa_1, kappa, d)  for i < r, k < t_1
  C_ijk  : (kappa_2, d)         for i <= j < r, k < t_2
  D_ijk  : (kappa_2, d)         for i <= j < r, k < t_1

The commitment kernels expand their tiles in registers from ``key`` and
these offsets; the methods below materialize tiles for the plain versions
and the tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .params import LabradorParams
from .ops import prg


@dataclass(frozen=True)
class CRS:
    """Seeded virtual CRS.  ``key`` is the (k0, k1) uint32 word pair the
    JAX package stores as its (2,) uint32 key array."""

    key: tuple[int, int]
    params: LabradorParams

    @classmethod
    def create(cls, params: LabradorParams, seed: int) -> "CRS":
        return cls(key=((seed >> 32) & prg.M32, seed & prg.M32),
                   params=params)

    # -- offset layout (verbatim from structs.rs:55-144) -------------------
    @property
    def _off_a(self) -> int:
        return 0

    @property
    def _off_b(self) -> int:
        p = self.params
        return p.kappa * p.n * p.d                      # structs.rs:78

    def _b_start(self, i: int, k: int, row: int = 0) -> int:
        p = self.params
        size_b = p.kappa_1 * p.kappa                    # quirk: no *d
        return self._off_b + (i * p.t_1 + k) * size_b + row * p.kappa * p.d

    @property
    def _off_c(self) -> int:
        p = self.params
        return self._off_b + p.r * p.t_1 * p.kappa_1 * p.kappa * p.d

    @staticmethod
    def _sum_pairs(i: int, r: int) -> int:
        return i * r - i * (i - 1) // 2 if i > 0 else 0     # structs.rs:101

    def _c_start(self, i: int, j: int, k: int) -> int:
        p = self.params
        off = k + p.t_1 * (self._sum_pairs(i, p.r) + (j - i))  # quirk: t_1
        return self._off_c + off * (p.kappa_2 * p.d)

    @property
    def _off_d(self) -> int:
        p = self.params
        return self._off_c + p.r * (p.r + 1) // 2 * (p.kappa_2 * p.d)

    def _d_start(self, i: int, j: int, k: int) -> int:
        p = self.params
        off = k + p.t_1 * (self._sum_pairs(i, p.r) + (j - i))
        return self._off_d + off * (p.kappa_2 * p.d)

    # -- fetchers ------------------------------------------------------------
    def a_rows(self, row0: int = 0, nrows: int | None = None,
               device=None) -> torch.Tensor:
        """(nrows, n, d) block of A (offset row * n * d)."""
        p = self.params
        nrows = p.kappa if nrows is None else nrows
        return self._expand(row0 * p.n * p.d, (nrows, p.n, p.d), device)

    def b_rows(self, i: int, k: int, row0: int = 0, nrows: int | None = None,
               device=None) -> torch.Tensor:
        """(nrows, kappa, d) block of B_ik (rows stride kappa * d)."""
        p = self.params
        nrows = p.kappa_1 if nrows is None else nrows
        return self._expand(self._b_start(i, k, row0), (nrows, p.kappa, p.d),
                            device)

    def c_vec(self, i: int, j: int, k: int, device=None) -> torch.Tensor:
        p = self.params
        return self._expand(self._c_start(i, j, k), (p.kappa_2, p.d), device)

    def d_vec(self, i: int, j: int, k: int, device=None) -> torch.Tensor:
        p = self.params
        return self._expand(self._d_start(i, j, k), (p.kappa_2, p.d), device)

    # -- expansion ------------------------------------------------------------
    def _expand(self, start: int, shape: tuple[int, ...],
                device=None) -> torch.Tensor:
        """Contiguous tile of ``shape`` starting at offset ``start``."""
        offs = torch.arange(math.prod(shape), dtype=torch.int64,
                            device=device) + start
        return self.draw(offs).reshape(shape)

    def _expand_dyn(self, base: int, idx0: int, stride0: int,
                    shape: tuple[int, ...], strides: tuple[int, ...],
                    idx1: int | None = None, stride1: int = 0,
                    device=None) -> torch.Tensor:
        """Strided tile: offset[i0, i1, ...] = base + idx0*stride0
        [+ idx1*stride1] + sum_k i_k * strides[k]."""
        start = base + idx0 * stride0
        if idx1 is not None:
            start += idx1 * stride1
        return self.draw(prg.offset_iota(start, shape, strides, device))

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        """CRS entries at int64 ``offsets`` (any shape)."""
        return prg.uniform_mod_q(self.key[0], self.key[1], offsets,
                                 self.params.q)

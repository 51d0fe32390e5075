"""Common Reference String: entries at global 64-bit offsets.

Counterpart of ``labrador_tpu/crs.py``: the virtual, lazily expanded
Threefry ``CRS`` and the reference-parity ``MaterializedCRS`` (every
coefficient drawn as the reference draws it, by a fresh ChaCha20 keyed by
base seed + offset, held as one flat table).  Both share the reference's
offset layout (``structs.rs:55-144``), in ``_CrsLayout``, with its two
quirks kept:

* the B-matrix stride ``(i*t_1 + k) * kappa_1 * kappa`` has no factor d
  (``structs.rs:82``);
* the C/D column offsets multiply the triangle index by t_1, also for C,
  which has t_2 digits (``structs.rs:106``).

Matrix shapes (coefficient domain, int64 residues in [0, q)):
  A      : (kappa, n, d)
  B_ik   : (kappa_1, kappa, d)  for i < r, k < t_1
  C_ijk  : (kappa_2, d)         for i <= j < r, k < t_2
  D_ijk  : (kappa_2, d)         for i <= j < r, k < t_1

Every fetcher reads through ``draw(offsets)``.  The commitment kernels
expand their tiles in registers from a ``CRS``'s ``key``, or read a
``MaterializedCRS``'s table (their table modes); the fetchers materialize
tiles for the plain versions, the recursion's streams and the tests.  A
``CRSBatch`` holds B Threefry CRSs of one parameter set for batched
proving (the kernels' batch modes); its ``draw`` gives every instance's
entries, (B,) + the offsets' shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .params import LabradorParams
from .ops import prg
from .ops.zq import is_big


class _CrsLayout:
    """The offset layout and the fetchers, shared by ``CRS`` and
    ``MaterializedCRS``; a subclass has ``params`` and ``draw``."""

    params: LabradorParams

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
               device="cuda") -> torch.Tensor:
        """(nrows, n, d) block of A (offset row * n * d)."""
        p = self.params
        nrows = p.kappa if nrows is None else nrows
        return self._expand(row0 * p.n * p.d, (nrows, p.n, p.d), device)

    def b_rows(self, i: int, k: int, row0: int = 0, nrows: int | None = None,
               device="cuda") -> torch.Tensor:
        """(nrows, kappa, d) block of B_ik (rows stride kappa * d)."""
        p = self.params
        nrows = p.kappa_1 if nrows is None else nrows
        return self._expand(self._b_start(i, k, row0), (nrows, p.kappa, p.d),
                            device)

    def a_rows_dyn(self, row0: int, nrows: int,
                   device="cuda") -> torch.Tensor:
        """(nrows, n, d) block of A from row0 (the JAX package's traced-
        offset fetcher; here the same tile as ``a_rows``)."""
        p = self.params
        return self._expand_dyn(0, row0, p.n * p.d, (nrows, p.n, p.d),
                                (p.n * p.d, p.d, 1), device=device)

    def b_mat_dyn(self, m: int, col0: int = 0, ncols: int | None = None,
                  device="cuda") -> torch.Tensor:
        """(kappa_1, ncols, d) column block of the m-th B matrix,
        m = i * t_1 + k (offset linear in m with the kappa_1 * kappa
        stride quirk), rows strided kappa * d."""
        p = self.params
        ncols = p.kappa if ncols is None else ncols
        return self._expand_dyn(self._off_b, m, p.kappa_1 * p.kappa,
                                (p.kappa_1, ncols, p.d),
                                (p.kappa * p.d, p.d, 1), idx1=col0,
                                stride1=p.d, device=device)

    def c_vec(self, i: int, j: int, k: int, device="cuda") -> torch.Tensor:
        p = self.params
        return self._expand(self._c_start(i, j, k), (p.kappa_2, p.d), device)

    def d_vec(self, i: int, j: int, k: int, device="cuda") -> torch.Tensor:
        p = self.params
        return self._expand(self._d_start(i, j, k), (p.kappa_2, p.d), device)

    # -- expansion ------------------------------------------------------------
    def _expand(self, start: int, shape: tuple[int, ...],
                device="cuda") -> torch.Tensor:
        """Contiguous tile of ``shape`` starting at offset ``start`` (of
        every instance of a ``CRSBatch``: (B,) + shape)."""
        offs = torch.arange(math.prod(shape), dtype=torch.int64,
                            device=device) + start
        vals = self.draw(offs)
        return vals.reshape(vals.shape[:-1] + tuple(shape))

    def _expand_dyn(self, base: int, idx0: int, stride0: int,
                    shape: tuple[int, ...], strides: tuple[int, ...],
                    idx1: int | None = None, stride1: int = 0,
                    device="cuda") -> torch.Tensor:
        """Strided tile: offset[i0, i1, ...] = base + idx0*stride0
        [+ idx1*stride1] + sum_k i_k * strides[k]."""
        start = base + idx0 * stride0
        if idx1 is not None:
            start += idx1 * stride1
        return self.draw(prg.offset_iota(start, shape, strides, device))


@dataclass(frozen=True)
class CRS(_CrsLayout):
    """Seeded virtual CRS.  ``key`` is the (k0, k1) uint32 word pair the
    JAX package stores as its (2,) uint32 key array."""

    key: tuple[int, int]
    params: LabradorParams

    @classmethod
    def create(cls, params: LabradorParams, seed: int) -> "CRS":
        return cls(key=((seed >> 32) & prg.M32, seed & prg.M32),
                   params=params)

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        """CRS entries at int64 ``offsets`` (any shape): Threefry."""
        return prg.uniform_mod_q(self.key[0], self.key[1], offsets,
                                 self.params.q)


@dataclass(frozen=True, eq=False)
class CRSBatch(_CrsLayout):
    """B Threefry CRSs of one parameter set: the counterpart of the
    ``(B, 2)`` CRS keys that the JAX package vmaps over (``bench.py``'s
    batch measurements, ``parallel/sharded.py``'s dp block).  ``words``
    holds the B (k0, k1) pairs on the host, ``keys`` the same as a (B, 2)
    int64 tensor on the batch's device, which the commitment kernels'
    batch modes read (one key per instance); the layout offsets are
    shared.  ``batch[b]`` is instance b's ``CRS``.  Only Threefry CRSs
    batch: a ``MaterializedCRS`` holds one table per process, and the JAX
    package never vmaps it either."""

    words: tuple[tuple[int, int], ...]
    keys: torch.Tensor
    params: LabradorParams

    @classmethod
    def stack(cls, crss, device="cuda") -> "CRSBatch":
        """The batch of the given Threefry ``CRS``s (one parameter set)."""
        crss = list(crss)
        if not crss:
            raise ValueError("a CRS batch needs at least one CRS")
        for c in crss:
            if type(c) is not CRS:
                raise TypeError(
                    f"a CRS batch takes Threefry CRSs only, not "
                    f"{type(c).__name__}: a MaterializedCRS is one table "
                    f"a process and is never batched")
            if c.params != crss[0].params:
                raise ValueError("a CRS batch takes one parameter set")
        return cls.from_keys(crss[0].params, [c.key for c in crss], device)

    @classmethod
    def create(cls, params: LabradorParams, seeds,
               device="cuda") -> "CRSBatch":
        """``CRS.create(params, seed)`` for each seed."""
        return cls.stack([CRS.create(params, s) for s in seeds], device)

    @classmethod
    def from_keys(cls, params: LabradorParams, keys,
                  device="cuda") -> "CRSBatch":
        """From B (k0, k1) uint32 word pairs (a list, or a (B, 2) array or
        tensor)."""
        words = tuple((int(k[0]) & prg.M32, int(k[1]) & prg.M32)
                      for k in keys)
        if not words:
            raise ValueError("a CRS batch needs at least one key")
        return cls(words=words, params=params,
                   keys=torch.tensor(words, dtype=torch.int64,
                                     device=device))

    def __len__(self) -> int:
        return len(self.words)

    def __getitem__(self, b):
        """Instance b's ``CRS``; a slice gives a sub-batch."""
        if isinstance(b, slice):
            return CRSBatch(words=self.words[b], keys=self.keys[b],
                            params=self.params)
        return CRS(key=self.words[b], params=self.params)

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        """Every instance's CRS entries at int64 ``offsets`` (any shape):
        (B,) + offsets.shape."""
        lead = (len(self),) + (1,) * offsets.dim()
        k0, k1 = (torch.tensor([w[i] for w in self.words], dtype=torch.int64,
                               device=offsets.device).reshape(lead)
                  for i in (0, 1))
        return prg.uniform_mod_q(k0, k1, offsets, self.params.q)


def _used_intervals(p: LabradorParams) -> list[tuple[int, int]]:
    """The coefficient-offset intervals the protocol reads, in the
    structs.rs:55-144 layout with its quirks (``labrador_tpu/crs.py``
    ``_used_intervals``): the B stride has no factor d (structs.rs:82), so
    consecutive B matrices overlap and a long gap that nothing reads lies
    between the last B coefficient read and _off_c; the C/D column offsets
    multiply by t_1 where C has t_2 digits (structs.rs:106), so C reads may
    run past _off_d into D's region."""
    size_b = p.kappa_1 * p.kappa
    off_b = p.kappa * p.n * p.d
    off_c = off_b + (p.r * p.t_1) * size_b * p.d
    n_tri = p.r * (p.r + 1) // 2
    off_d = off_c + n_tri * (p.kappa_2 * p.d)
    b_end = off_b + (p.r * p.t_1 - 1) * size_b + p.kappa_1 * p.kappa * p.d
    c_end = off_c + ((p.t_2 - 1) + p.t_1 * (n_tri - 1) + 1) * p.kappa_2 * p.d
    d_end = off_d + ((p.t_1 - 1) + p.t_1 * (n_tri - 1) + 1) * p.kappa_2 * p.d
    return [(0, b_end), (off_c, max(c_end, d_end))]


@dataclass(frozen=True, eq=False)
class MaterializedCRS(_CrsLayout):
    """Reference-parity CRS: the coefficients the reference's lazy oracle
    draws (``CRS::generate_random_coeff``, structs.rs:147-171, bit for bit:
    ``native/chacha_compat.cpp``), generated on the host and held as one
    flat int32 table of residues in [0, q) on the caller's device.  Only
    the intervals the protocol reads are generated (``_used_intervals``);
    the gaps between them hold zeros, and a read beyond the table gives 0,
    as the JAX class's ``jnp.take(..., mode="fill", fill_value=0)``.
    ``key`` is the FS salt: the first 8 bytes of the base seed as two
    big-endian words, as in the JAX class.  On the card the commitment
    kernels read the table (their table modes)."""

    coeffs: torch.Tensor         # (total,) int32 residues in [0, q)
    key: tuple[int, int]
    params: LabradorParams

    @classmethod
    def create_chacha(cls, params: LabradorParams, base_seed: bytes,
                      device="cuda") -> "MaterializedCRS":
        """Every protocol-read coefficient from ``base_seed`` exactly as
        the reference's oracle draws it.  Small q only: the reference runs
        at no big modulus."""
        from . import native
        if len(base_seed) != 32:
            raise ValueError("base_seed must be 32 bytes")
        if is_big(params.q):
            raise ValueError(f"no reference-parity CRS at q = {params.q}: "
                             f"reference parity exists at small q only")
        intervals = _used_intervals(params)
        coeffs = torch.zeros(intervals[-1][1], dtype=torch.int32,
                             device=device)
        for lo, hi in intervals:
            vals = native.crs_coeffs(base_seed, lo, hi - lo, params.q)
            coeffs[lo:hi] = torch.from_numpy(vals.astype("int32")).to(device)
        key = (int.from_bytes(base_seed[:4], "big"),
               int.from_bytes(base_seed[4:8], "big"))
        return cls(coeffs=coeffs, key=key, params=params)

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        """Table entries at int64 ``offsets`` (any shape) as int64
        residues, 0 beyond the table.  The offsets must lie on the
        table's device."""
        if offsets.device != self.coeffs.device:
            raise ValueError(f"offsets on {offsets.device}, the CRS table "
                             f"on {self.coeffs.device}")
        inside = offsets < self.coeffs.numel()
        vals = torch.take(self.coeffs, torch.where(inside, offsets, 0))
        return torch.where(inside, vals, 0).to(torch.int64)

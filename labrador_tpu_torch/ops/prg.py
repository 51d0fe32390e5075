"""Counter-mode Threefry-2x32 PRG (the CRS expansion and every random draw).

Counterpart of ``labrador_tpu/ops/prg.py``.  uint32 words are carried in
int64 tensors and masked after every add and shift (``torch.uint32`` has no
arithmetic on the CPU); the bits equal the JAX package's on any device.
The CUDA kernels run the same block in registers (``csrc/threefry.cuh``).
"""

from __future__ import annotations

import torch

from .modmath import P_MAX

M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0: torch.Tensor, c1: torch.Tensor):
    """One 20-round Threefry-2x32 block per element: keys (k0, k1) — Python
    ints or int64 tensors holding uint32 words — and counter words (c0, c1)
    -> output words (x0, x1) as int64 tensors in [0, 2**32)."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    inject = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for step, (a, b) in enumerate(inject):
        for r in (_ROT_A if step % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & M32
        x1 = (x1 + b + step + 1) & M32
    return x0, x1


def words_mod_q(x0: torch.Tensor, x1: torch.Tensor, q: int) -> torch.Tensor:
    """(x0 * 2**32 + x1) mod q for uint32 words (held in int64)."""
    return torch.remainder(torch.remainder(x0, q) * ((1 << 32) % q)
                           + torch.remainder(x1, q), q)


def uniform_mod_q(k0: int, k1: int, offsets: torch.Tensor, q: int):
    """Draw in [0, q) at 64-bit counters ``offsets`` (int64, nonnegative):
    the 64-bit Threefry output reduced mod q, as ``prg.uniform_mod_q``."""
    if q > P_MAX:
        raise NotImplementedError(
            "big q (two-limb residues) belongs to the big-q slice of the port")
    x0, x1 = threefry2x32(k0, k1, offsets >> 32, offsets & M32)
    return words_mod_q(x0, x1, q)


def offset_iota(start: int, shape, strides, device) -> torch.Tensor:
    """int64 offsets start + sum_k i_k * strides[k] over ``shape`` (the 64-bit
    offset arithmetic the JAX package emulates on uint32 pairs)."""
    off = torch.full((1,) * len(shape), start, dtype=torch.int64,
                     device=device)
    for ax, (n_ax, s_ax) in enumerate(zip(shape, strides)):
        bshape = [1] * len(shape)
        bshape[ax] = n_ax
        off = off + (torch.arange(n_ax, dtype=torch.int64, device=device)
                     * s_ax).reshape(bshape)
    return off.expand(tuple(shape))

"""Plain PyTorch version of the commitment kernels' shared contraction.

    out[j, row] = sum_l M(l, row) (*) dig[j, l]   mod q

(``(*)`` the negacyclic product), with the CRS tile M drawn chunk by chunk
and contracted against the negacyclic circulant of the centred digits in
one float64 matmul per chunk (``modmath.matmul_mod``, exact).  This is what
``csrc/threefry.cuh``'s ring-stream kernel computes; the CPU path and the
tests use it, and ``chip_smoke.py`` holds the kernels against it.  Also the
shared launch plumbing of the three CUDA wrappers.
"""

from __future__ import annotations

from typing import Callable

import torch

from .modmath import P_MAX, matmul_mod, mod_pos
from .zq import to_signed_small

# CRS entries drawn per plain-version chunk (bounds its temporaries)
_CHUNK_ENTRIES = 1 << 22
# blocks the CUDA launch aims for: a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
_LC = 8            # ring elements per kernel chunk (csrc/threefry.cuh LC)
_GROUPS = 4        # right-hand sides per block (csrc/threefry.cuh GROUPS)


def circulant(v: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d, d) negacyclic circulant C[..., i, k] =
    sign(k >= i) * v[..., (k - i) mod d], so a @ C is the product a (*) v."""
    d = v.shape[-1]
    i = torch.arange(d, device=v.device)[:, None]
    k = torch.arange(d, device=v.device)[None, :]
    sign = torch.where(k >= i, 1, -1).to(v.dtype)
    return v[..., (k - i) % d] * sign


def ring_stream_plain(draw: Callable[[int, int], torch.Tensor],
                      dig: torch.Tensor, rows: int, q: int) -> torch.Tensor:
    """out (nrhs, rows, d) for dig (nrhs, L, d) residues in [0, q);
    ``draw(l0, l1)`` returns the CRS tile M (rows, l1 - l0, d)."""
    nrhs, L, d = dig.shape
    dig_c = to_signed_small(dig, q)
    nl = max(1, _CHUNK_ENTRIES // (rows * d))
    out = torch.zeros((nrhs, rows, d), dtype=torch.int64, device=dig.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = draw(l0, l1).reshape(1, rows, (l1 - l0) * d)
        c = circulant(dig_c[:, l0:l1]).reshape(nrhs, (l1 - l0) * d, d)
        out = mod_pos(out + matmul_mod(m, c, q, q - 1, q // 2), q)
    return out


def check_small_q(q: int, d: int) -> None:
    if q > P_MAX:
        raise NotImplementedError(
            "the commitment kernels take q <= P_MAX; big q is a later slice")
    if d != 64:
        raise ValueError("the commitment kernels are built for d = 64")


def launch_shape(rows: int, nrhs: int, L: int) -> int:
    """Splits of the l stream over grid.y for a (rows, splits, rhs groups)
    grid of about _TARGET_BLOCKS blocks."""
    zb = 1 if nrhs == 1 else -(-nrhs // _GROUPS)
    want = -(-_TARGET_BLOCKS // (rows * zb))
    return max(1, min(want, -(-L // _LC), 65535))

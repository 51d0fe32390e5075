"""Plain PyTorch version of the commitment kernels' shared contraction.

    out[j, row] = sum_l M(l, row) (*) dig[j, l]   mod q

(``(*)`` the negacyclic product), with the CRS tile M drawn chunk by chunk
and contracted against the negacyclic circulant of the centred digits in
one float64 matmul per chunk (``modmath.matmul_mod``, exact).  At big q a
product of an entry and a centred operand (both up to q/2 ~ 2^31) is
beyond float64's exact range, so the contraction runs per CRT prime and
one signed Garner fold (``zq.fold_res_modq``) gives the sum mod q, as the
JAX package's XLA path does.  This is what the tensor-core kernels of
``csrc/ajtai.cu`` (Ajtai) and ``csrc/mma_stream.cuh`` (u1, C/D) compute;
the CPU path and the tests use it, and ``chip_smoke.py`` holds the
kernels against it.  The operands may be
residues in [0, q) or signed values of magnitude at most q/2 (the big-q
convention of the JAX package: signed digits and witness); the kernel and
this version centre them alike.  Also the modulus check of the three
CUDA wrappers, the big-q operand check of the Ajtai wrapper, and the
Barrett constant of the kernels' reduction of a Threefry word.
"""

from __future__ import annotations

from typing import Callable

import torch

from .modmath import P_MAX, Q_BIG_MAX, matmul_mod, mod_pos
from .ntt import make_plan
from .zq import fold_res_modq, is_big, to_res, to_signed_small

# CRS entries drawn, and circulant entries built, per plain-version chunk
# (bounds its temporaries)
_CHUNK_ENTRIES = 1 << 22


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
    """out (nrhs, rows, d) for dig (nrhs, L, d) residues in [0, q) or signed
    values; ``draw(l0, l1)`` returns the CRS tile M (rows, l1 - l0, d)."""
    nrhs, L, d = dig.shape
    dig_c = to_signed_small(dig, q)
    nl = max(1, min(_CHUNK_ENTRIES // (rows * d),
                    _CHUNK_ENTRIES // (nrhs * d * d)))
    if is_big(q):
        return _ring_stream_crt(draw, dig_c, rows, q, nl)
    out = torch.zeros((nrhs, rows, d), dtype=torch.int64, device=dig.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = draw(l0, l1).reshape(1, rows, (l1 - l0) * d)
        c = circulant(dig_c[:, l0:l1]).reshape(nrhs, (l1 - l0) * d, d)
        out = mod_pos(out + matmul_mod(m, c, q, q - 1, q // 2), q)
    return out


def _ring_stream_crt(draw, dig_c: torch.Tensor, rows: int, q: int,
                     nl: int) -> torch.Tensor:
    """The big-q plain contraction: per CRT prime, then one Garner fold.
    The plan's primes cover |sum| <= L d (q - 1) q / 2 (every |dig_c| <=
    q/2), so the signed fold is exact."""
    nrhs, L, d = dig_c.shape
    plan = make_plan(q, d, max_accum=1 << max(10, (L - 1).bit_length()))
    P, pm = plan.n_primes, max(plan.primes)
    pv = plan.pv(dig_c.device, 4)
    acc = torch.zeros((P, nrhs, rows, d), dtype=torch.int64,
                      device=dig_c.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = to_res(draw(l0, l1).reshape(1, rows, (l1 - l0) * d), plan)
        c = circulant(to_res(dig_c[:, l0:l1], plan)).reshape(
            P, nrhs, (l1 - l0) * d, d)
        acc = mod_pos(acc + matmul_mod(m, c, pv, pm - 1, pm - 1), pv)
    return fold_res_modq(acc, plan, signed=True)


def check_q(q: int, d: int) -> None:
    """The moduli the kernels take, those of ``ntt.make_plan``: q <= P_MAX,
    or 2^32 < q <= Q_BIG_MAX."""
    if not (q <= P_MAX or (1 << 32) < q <= Q_BIG_MAX):
        raise ValueError(f"no commitment kernel for q = {q}")
    if d != 64:
        raise ValueError("the commitment kernels are built for d = 64")


def check_big_operand(x: torch.Tensor, q: int, name: str) -> None:
    """At big q the Ajtai kernel takes operands in [-q/2, q): residues or
    signed values, centred alike to |x| <= q/2, which its five signed
    8-bit limbs hold.  Raise on one outside (one device sync)."""
    if is_big(q) and x.numel():
        lo, hi = torch.stack(torch.aminmax(x)).tolist()
        if lo < -(q // 2) or hi >= q:
            raise ValueError(f"{name} has values in [{lo}, {hi}], outside "
                             f"[-q/2, q) for the big-q kernel")


def barrett_m(q: int) -> int:
    """floor((2^64 - 1) / q): the Barrett constant with which the kernels
    reduce each 64-bit Threefry word mod q (``csrc/threefry.cuh``
    ``barrett_mod``, where the bound is proved)."""
    return ((1 << 64) - 1) // q


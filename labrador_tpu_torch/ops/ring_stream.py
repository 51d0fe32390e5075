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
CUDA wrappers, their choice of mode by the CRS's type (``entry_table``:
Threefry or table; ``instances``: one instance or a ``crs.CRSBatch``),
the key words a Threefry launch reads (``device_keys``), the big-q
operand check of the Ajtai wrapper, and the Barrett constant of the
kernels' reduction of a Threefry word.  With a leading instance axis the
plain contraction takes every instance of a batch at once.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from ..crs import CRS, CRSBatch, MaterializedCRS
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
    """out (..., nrhs, rows, d) for dig (..., nrhs, L, d) residues in [0, q)
    or signed values; ``draw(l0, l1)`` returns the CRS tile M (..., rows,
    l1 - l0, d).  The leading axes, where present, are the instances of a
    batch (a ``crs.CRSBatch``: each its own CRS tile and digits)."""
    *lead, nrhs, L, d = dig.shape
    lead = tuple(lead)
    dig_c = to_signed_small(dig, q)
    per = math.prod(lead)
    nl = max(1, min(_CHUNK_ENTRIES // (per * rows * d),
                    _CHUNK_ENTRIES // (per * nrhs * d * d)))
    if is_big(q):
        return _ring_stream_crt(draw, dig_c, rows, q, nl)
    out = torch.zeros(lead + (nrhs, rows, d), dtype=torch.int64,
                      device=dig.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = draw(l0, l1).reshape(lead + (1, rows, (l1 - l0) * d))
        c = circulant(dig_c[..., l0:l1, :]).reshape(
            lead + (nrhs, (l1 - l0) * d, d))
        out = mod_pos(out + matmul_mod(m, c, q, q - 1, q // 2), q)
    return out


def _ring_stream_crt(draw, dig_c: torch.Tensor, rows: int, q: int,
                     nl: int) -> torch.Tensor:
    """The big-q plain contraction: per CRT prime, then one Garner fold.
    The plan's primes cover |sum| <= L d (q - 1) q / 2 (every |dig_c| <=
    q/2), so the signed fold is exact."""
    *lead, nrhs, L, d = dig_c.shape
    lead = tuple(lead)
    plan = make_plan(q, d, max_accum=1 << max(10, (L - 1).bit_length()))
    P, pm = plan.n_primes, max(plan.primes)
    pv = plan.pv(dig_c.device, len(lead) + 4)
    acc = torch.zeros((P,) + lead + (nrhs, rows, d), dtype=torch.int64,
                      device=dig_c.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = to_res(draw(l0, l1).reshape(lead + (1, rows, (l1 - l0) * d)),
                   plan)
        c = circulant(to_res(dig_c[..., l0:l1, :], plan)).reshape(
            (P,) + lead + (nrhs, (l1 - l0) * d, d))
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


def entry_table(crs, device: torch.device) -> torch.Tensor | None:
    """Which mode of a commitment kernel a CRS takes on ``device``: the
    table of a ``crs.MaterializedCRS`` (its table mode), or None for a
    Threefry ``crs.CRS`` or ``crs.CRSBatch`` (the modes that expand it in
    the kernel).  Raises for any other object, so that no such CRS reaches
    a Threefry launch with its key, and for a table on another device.
    There is no big-q table mode: ``MaterializedCRS.create_chacha``
    refuses big q."""
    if isinstance(crs, MaterializedCRS):
        if crs.coeffs.device != device:
            raise ValueError(f"the CRS table lies on {crs.coeffs.device}, "
                             f"the operands on {device}")
        if is_big(crs.params.q):
            raise ValueError(f"no table mode at q = {crs.params.q}: the "
                             f"reference-parity CRS exists at small q only")
        if crs.coeffs.dtype != torch.int32 or crs.coeffs.dim() != 1 \
                or not crs.coeffs.is_contiguous():
            raise ValueError("the CRS table must be a contiguous 1-D int32 "
                             "tensor")
        return crs.coeffs
    if isinstance(crs, (CRS, CRSBatch)):
        return None
    raise TypeError(f"no commitment kernel for a CRS of type "
                    f"{type(crs).__name__}")


def instances(crs) -> int | None:
    """The instances of a batched call: len(crs) for a ``crs.CRSBatch``,
    None for a single CRS (whose operands have no instance axis)."""
    return len(crs) if isinstance(crs, CRSBatch) else None


@functools.lru_cache(maxsize=256)
def _single_keys(k0: int, k1: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([[k0, k1]], dtype=torch.int64, device=device)


def device_keys(crs, device: torch.device) -> torch.Tensor:
    """The (instances, 2) int64 key words a Threefry launch reads on
    ``device``: a ``CRSBatch``'s own tensor, or a single ``CRS``'s key as a
    batch of one (kept once per key and device, so a launch copies no key
    to the card)."""
    if isinstance(crs, CRSBatch):
        if crs.keys.device != device:
            raise ValueError(f"the CRS batch's keys lie on "
                             f"{crs.keys.device}, the operands on {device}")
        return crs.keys
    return _single_keys(crs.key[0], crs.key[1], device)


def barrett_m(q: int) -> int:
    """floor((2^64 - 1) / q): the Barrett constant with which the kernels
    reduce each 64-bit Threefry word mod q (``csrc/threefry.cuh``
    ``barrett_mod``, where the bound is proved)."""
    return ((1 << 64) - 1) // q


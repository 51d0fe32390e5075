"""The three CRS-consuming commitments in plain PyTorch.

    out[j, row] = sum_l M(l, row) (*) dig[j, l]   mod q

(``(*)`` the negacyclic product), with the CRS tile M drawn chunk by chunk
and contracted against the negacyclic circulant of the centred operands.
A product of an entry and a centred operand (both up to q/2 ~ 2^31 at
the big modulus) is beyond float64's exact range, so the contraction runs
per CRT prime and one signed Garner fold gives the sum mod q.
"""

from __future__ import annotations

from typing import Callable

import torch

from .crs import CRS
from .modmath import matmul_mod, mod_pos
from .ntt import make_plan
from .zq import fold_res_modq, is_big, to_res, to_signed_small

# CRS entries drawn, and circulant entries built, per chunk
_CHUNK_ENTRIES = 1 << 22


def circulant(v: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d, d) negacyclic circulant C[..., i, k] =
    sign(k >= i) * v[..., (k - i) mod d], so a @ C is the product a (*) v."""
    d = v.shape[-1]
    i = torch.arange(d, device=v.device)[:, None]
    k = torch.arange(d, device=v.device)[None, :]
    sign = torch.where(k >= i, 1, -1).to(v.dtype)
    return v[..., (k - i) % d] * sign


def ring_stream(draw: Callable[[int, int], torch.Tensor], dig: torch.Tensor,
                rows: int, q: int) -> torch.Tensor:
    """out (nrhs, rows, d) for dig (nrhs, L, d) residues in [0, q) or
    signed values; ``draw(l0, l1)`` returns the CRS tile (rows, l1 - l0,
    d)."""
    nrhs, L, d = dig.shape
    dig_c = to_signed_small(dig, q)
    nl = max(1, min(_CHUNK_ENTRIES // (rows * d),
                    _CHUNK_ENTRIES // (nrhs * d * d)))
    if not is_big(q):
        raise ValueError(f"the reference runs at big q only, not q = {q}")
    # the primes cover |sum| <= L d (q - 1) q / 2, so the fold is exact
    plan = make_plan(q, d, max_accum=1 << max(10, (L - 1).bit_length()))
    P, pm = plan.n_primes, max(plan.primes)
    pv = plan.pv(dig.device, 4)
    acc = torch.zeros((P, nrhs, rows, d), dtype=torch.int64,
                      device=dig.device)
    for l0 in range(0, L, nl):
        l1 = min(L, l0 + nl)
        m = to_res(draw(l0, l1).reshape(1, rows, (l1 - l0) * d), plan)
        c = circulant(to_res(dig_c[:, l0:l1, :], plan)).reshape(
            P, nrhs, (l1 - l0) * d, d)
        acc = mod_pos(acc + matmul_mod(m, c, pv, pm - 1, pm - 1), pv)
    return fold_res_modq(acc, plan, signed=True)


def ajtai_commit(crs: CRS, witness: torch.Tensor) -> torch.Tensor:
    """t_i = A s_i: (r_eff, n, d) -> (r_eff, kappa, d) mod q."""
    p = crs.params
    nd = p.n * p.d

    def draw(l0: int, l1: int) -> torch.Tensor:
        return crs.expand(l0 * p.d, (p.kappa, l1 - l0, p.d), (nd, p.d, 1),
                          witness.device)

    return ring_stream(draw, witness, p.kappa, p.q)


def u1_bterm(crs: CRS, t_dig: torch.Tensor) -> torch.Tensor:
    """sum_{i,k} B_ik t_i^(k) -> (kappa_1, d) for t_dig (t_1, r, kappa,
    d): one stream over l = m * kappa + col, m = i * t_1 + k."""
    p = crs.params
    dev = t_dig.device
    stream = torch.swapaxes(t_dig, -4, -3).reshape(
        1, p.r * p.t_1 * p.kappa, p.d).contiguous()

    def draw(l0: int, l1: int) -> torch.Tensor:
        lin = torch.arange(l0, l1, device=dev)
        col_off = (lin // p.kappa) * (p.kappa_1 * p.kappa) \
            + (lin % p.kappa) * p.d
        row_off = torch.arange(p.kappa_1, device=dev) * (p.kappa * p.d)
        c = torch.arange(p.d, device=dev)
        return crs.draw(crs._off_b + row_off[:, None, None]
                        + col_off[None, :, None] + c[None, None, :])

    return ring_stream(draw, stream, p.kappa_1, p.q)[0]


def cd_sum(crs: CRS, dig_stream: torch.Tensor, base_off: int,
           t_used: int) -> torch.Tensor:
    """sum_{tri, k} M_(tri, k) dig[tri, k] -> (kappa_2, d) for dig_stream
    (n_tri, t_used, d); ``base_off`` the C or the D region."""
    p = crs.params
    dev = dig_stream.device
    dig = dig_stream.reshape(-1, p.d)

    def draw(la: int, lb: int) -> torch.Tensor:
        lin = torch.arange(la, lb, device=dev)
        oc = (lin // t_used) * p.t_1 + lin % t_used
        row = torch.arange(p.kappa_2, device=dev)
        c = torch.arange(p.d, device=dev)
        return crs.draw(base_off + oc[None, :, None] * (p.kappa_2 * p.d)
                        + row[:, None, None] * p.d + c[None, None, :])

    return ring_stream(draw, dig[None], p.kappa_2, p.q)[0]


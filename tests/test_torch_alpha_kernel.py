"""The alpha-contraction kernel (``csrc/alpha.cu`` on the stream kernel of
``csrc/mma_stream.cuh``), modelled on the CPU.

* Its three offset functors (``AlphaAOffset``, ``AlphaBOffset``,
  ``AlphaCdPassOffset``), stream(rho) + row(r) + c as the kernel computes
  them, give the offsets that the plain version's fetchers expand
  (``a_rows_dyn``, ``b_mat_dyn``, ``_expand_dyn``), at config 1 and at the
  fold cell's 2^14 big-q base.
* The full-residue operand: a weight centred as the kernel centres it and
  split into as many signed 8-bit limbs as an entry has
  (``entry_limbs(q)``) is exact for 0, 1,
  +-(q - 1)/2 and q - 1 and random residues, at q = 8191 and 4294967311;
  the flush length, from the header's constants, follows from min(entry
  limbs, weight limbs).
* A torch model of the kernel's arithmetic with those offsets and limbs
  (int32 sums per limb weight between flushes, asserted inside int32;
  recombination mod q) equals the plain version of each pass.

The kernel itself, each pass and ``FoldedState.phi_alpha_modq`` on the
kernel route, is held against the plain route on a card by
``tests/test_torch_cuda.py``.
"""

import re

import numpy as np
import pytest
import torch

from labrador_tpu_torch import recursion
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.ops import alpha_cuda, cuda_lib, u1_cuda
from labrador_tpu_torch.ops.modmath import mod_pos, mulmod
from labrador_tpu_torch.ops.ring_stream import circulant
from labrador_tpu_torch.ops.zq import to_signed_small
from labrador_tpu_torch.params import LabradorParams

Q_SMALL, Q_BIG = 8191, 4294967311
BIG = dict(q_start=(1 << 32) - 1, exact_digits=True)
FOLD = dict(n=16, r=16, kappa_override=256, **BIG)   # the fold cell's base
SEED = 0xA1FA
D = 64


def _params(shape: str, q: int = Q_SMALL, **kw) -> LabradorParams:
    if shape == "fold":
        return LabradorParams(**FOLD)
    return LabradorParams(n=2, r=2, **(BIG if q == Q_BIG else {}), **kw)


class _OffsetCRS(CRS):
    """A CRS whose entries are their own offsets: its fetchers return the
    offsets they expand."""

    def draw(self, offsets: torch.Tensor) -> torch.Tensor:
        return offsets


# The functors of csrc/alpha.cu: (stream(rho), row(r)) as the kernel
# computes them, in int64 (the offsets stay far below 2^63).
def alpha_a_offset(n: int):
    return (lambda l: l * n * D), (lambda r: r * D)


def alpha_b_offset(off_b: int, kappa: int, kappa1: int):
    def row(r):
        m = r // kappa
        return off_b + m * kappa1 * kappa + (r - m * kappa) * D
    return (lambda l: l * kappa * D), row


def alpha_cd_offset(base: int, t_used: int, t1: int, kappa2: int):
    def row(r):
        return base + ((r // t_used) * t1 + r % t_used) * kappa2 * D
    return (lambda l: l * D), row


def functor_offsets(off, L: int, rows) -> torch.Tensor:
    """(L, len(rows), D): stream(rho) + row(r) + c."""
    stream, row = off
    rows = torch.as_tensor(rows, dtype=torch.int64)
    return (stream(torch.arange(L))[:, None, None] + row(rows)[None, :, None]
            + torch.arange(D)[None, None, :])


def _offsets(off_of, p):
    return off_of(_OffsetCRS(key=(0, 0), params=p))


@pytest.mark.parametrize("shape", ["config1", "fold"])
def test_alpha_a_offset_matches_fetcher(shape):
    p = _params(shape)
    want = _offsets(lambda c: c.a_rows_dyn(0, p.kappa, device="cpu"), p)
    got = functor_offsets(alpha_a_offset(p.n), p.kappa, range(p.n))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", ["config1", "fold"])
def test_alpha_b_offset_matches_fetcher(shape):
    """Every B matrix at config 1; at the fold base (64 matrices of 4 Mi
    entries) the first two, a middle one and the last."""
    p = _params(shape)
    crs = _OffsetCRS(key=(0, 0), params=p)
    m_total = p.r * p.t_1
    off = alpha_b_offset(crs._off_b, p.kappa, p.kappa_1)
    ms = range(m_total) if shape == "config1" else (0, 1, m_total // 2,
                                                     m_total - 1)
    for m in ms:
        want = crs.b_mat_dyn(m, device="cpu")            # (kappa_1, kappa, d)
        got = functor_offsets(off, p.kappa_1,
                              range(m * p.kappa, (m + 1) * p.kappa))
        assert torch.equal(got, want), m


@pytest.mark.parametrize("use", ["C", "D"])
@pytest.mark.parametrize("shape", ["config1", "fold"])
def test_alpha_cd_offset_matches_fetcher(shape, use):
    """The C pass over t_2 < t_1 digits a pair, where the row offset is not
    affine in the row index, and the D pass over t_1."""
    p = _params(shape)
    crs = _OffsetCRS(key=(0, 0), params=p)
    base, t_used = ((crs._off_c, p.t_2) if use == "C"
                    else (crs._off_d, p.t_1))
    if use == "C":
        assert t_used < p.t_1
    n_tri = p.r * (p.r + 1) // 2
    col = p.kappa_2 * p.d
    want = crs._expand_dyn(base, 0, p.t_1 * col,
                           (n_tri, t_used, p.kappa_2, p.d),
                           (p.t_1 * col, col, p.d, 1), device="cpu")
    got = functor_offsets(alpha_cd_offset(base, t_used, p.t_1, p.kappa_2),
                          p.kappa_2, range(n_tri * t_used))
    assert torch.equal(got.permute(1, 0, 2),
                       want.reshape(n_tri * t_used, p.kappa_2, p.d))


def _s8_limbs(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Signed 8-bit limbs as the kernel builds its circulant words; raises
    if x is beyond them."""
    out, v = [], x
    for _ in range(n):
        limb = ((v + 128) & 255) - 128
        out.append(limb)
        v = (v - limb) >> 8
    if not torch.equal(v, torch.zeros_like(v)):
        raise AssertionError("weight beyond its limbs")
    return out


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG])
def test_full_residue_limb_split(q):
    """Every residue, centred (x > q/2 -> x - q), splits exactly into
    entry_limbs(q) signed limbs, which recombine to a value = x mod q; at
    big q the centred edges lie beyond int32 and beyond 4 limbs."""
    n = u1_cuda.entry_limbs(q)
    assert n == (2 if q == Q_SMALL else 5)
    edges = [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]
    rng = np.random.default_rng(q % 1009)
    x = torch.tensor(edges + [int(v) for v in rng.integers(0, q, 100_000)],
                     dtype=torch.int64)
    c = to_signed_small(x, q)
    assert int(c.abs().max()) == (q - 1) // 2
    assert int(c.abs().max()) <= u1_cuda.limb_cover(n)
    limbs = _s8_limbs(c, n)
    for limb in limbs:
        assert int(limb.min()) >= -128 and int(limb.max()) <= 127
    back = sum(limb << (8 * k) for k, limb in enumerate(limbs))
    assert torch.equal(back, c)
    assert torch.equal(mod_pos(back, q), x)
    if q == Q_BIG:
        assert (q - 1) // 2 > (1 << 31) - 1
        assert (q - 1) // 2 > u1_cuda.limb_cover(4)
        with pytest.raises(AssertionError, match="beyond"):
            _s8_limbs(c, 4)


_HEADER = (cuda_lib.CSRC / "mma_stream.cuh").read_text()


def _header_int(pattern: str) -> int:
    return int(re.search(pattern, _HEADER)[1])


def header_flush_len(pairs: int) -> int:
    """mma_flush_len of csrc/mma_stream.cuh, its constants parsed from the
    header: halve MMA_FLUSH_L while 2 F pairs P M exceeds the int32 top, P
    the products an mma adds to a sum and M their largest magnitude."""
    f = _header_int(r"constexpr int MMA_FLUSH_L = (\d+);")
    n_prod, top, lim = map(int, re.search(
        r"while \(2LL \* f \* pairs \* (\d+) \* (\d+) > (\d+)LL\) "
        r"f /= 2;", _HEADER).groups())
    assert (n_prod, top, lim) == (32, 255 * 128, (1 << 31) - 1)
    while 2 * f * pairs * n_prod * top > lim:
        f //= 2
    return f


def test_flush_length_from_limb_pairs():
    """mma_flush_len: the int32 sums of a weight, 2 F P 32 products of at
    most 255 * 128 between flushes, fit int32; at the full operand's 5
    pairs F halves to 128, where 256 would overflow; the bounded-digit
    modes (at most 4 pairs) keep 256, the FLUSH_L of the u1 and C/D
    wrappers.  The header's static_assert and the kernel's flush length
    (min of the entry and digit limbs) say the same."""
    top = 255 * 128
    for pairs in range(1, 5):
        assert header_flush_len(pairs) == u1_cuda.FLUSH_L == 256
        assert 2 * 256 * pairs * 32 * top <= (1 << 31) - 1
    f = header_flush_len(5)
    assert f == 128
    assert 2 * f * 5 * 32 * top == 1_336_934_400 <= (1 << 31) - 1
    assert 2 * 2 * f * 5 * 32 * top == 2_673_868_800 > (1 << 31) - 1
    assert re.search(r"static_assert\(mma_flush_len\(4\) == MMA_FLUSH_L && "
                     r"mma_flush_len\(5\) == 128,", _HEADER)
    assert "constexpr int FLUSH = mma_flush_len(EL < DL ? EL : DL);" \
        in _HEADER
    # the full operand: as many weight limbs as entry limbs, min = EL
    assert header_flush_len(u1_cuda.entry_limbs(Q_BIG)) == 128
    assert header_flush_len(u1_cuda.entry_limbs(Q_SMALL)) == 256


def full_limb_model(crs, off, w: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, d) mod q: what the kernel computes for weights w (L, d), in
    its limbs: entries as unsigned 8-bit limbs, centred weights as as many
    signed ones, per flush period the int32 sum of each
    limb weight (float64 products, exact below 2^53), asserted inside
    int32, then sum_w (2^(8w) mod q) S_w mod q."""
    q = crs.params.q
    L = w.shape[0]
    el = wl = u1_cuda.entry_limbs(q)
    flush = header_flush_len(min(el, wl))
    w_c = to_signed_small(w, q)
    stream, row = off
    res = torch.zeros((rows, D), dtype=torch.int64)
    for l0 in range(0, L, flush):
        l1 = min(L, l0 + flush)
        offs = (stream(torch.arange(l0, l1))[None, :, None]
                + row(torch.arange(rows))[:, None, None]
                + torch.arange(D)[None, None, :])
        m = crs.draw(offs).reshape(rows, (l1 - l0) * D)
        circ = circulant(w_c[l0:l1]).reshape((l1 - l0) * D, D)
        em = [(m >> (8 * k)) & 255 for k in range(el)]
        dm = _s8_limbs(circ, wl)
        sums = [torch.zeros((rows, D), dtype=torch.int64)
                for _ in range(el + wl - 1)]
        for a in range(el):
            for b in range(wl):
                sums[a + b] += (em[a].double() @ dm[b].double()).to(
                    torch.int64)
        for k, s in enumerate(sums):
            assert int(s.min()) >= -(1 << 31) and int(s.max()) < 1 << 31
            res = mod_pos(res + mulmod(mod_pos(s, q), (1 << (8 * k)) % q, q),
                          q)
    return res


def _weights(q: int, L: int, seed: int) -> torch.Tensor:
    """(L, d) residues, the edges 0, 1, +-(q - 1)/2, q - 1 first."""
    x = np.random.default_rng(seed).integers(0, q, (L, D))
    x.reshape(-1)[:5] = [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]
    return torch.from_numpy(x)


@pytest.mark.parametrize("use", ["A", "B", "C", "D"])
@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG])
def test_full_limb_model_matches_plain(q, use):
    """Each pass at n = r = 2, kappa = 16 through the kernel's offsets and
    limbs equals its plain version."""
    p = _params("config1", q, kappa_override=16)
    crs = CRS.create(p, SEED)
    n_tri = p.r * (p.r + 1) // 2
    if use == "A":
        w = _weights(q, p.kappa, 1)
        got = full_limb_model(crs, alpha_a_offset(p.n), w, p.n)
        want = alpha_cuda.alpha_a_plain(crs, w)
    elif use == "B":
        w = _weights(q, p.kappa_1, 2)
        rows = p.r * p.t_1 * p.kappa
        got = full_limb_model(
            crs, alpha_b_offset(crs._off_b, p.kappa, p.kappa_1), w, rows)
        want = alpha_cuda.alpha_b_plain(crs, w)
    else:
        base, t_used = ((crs._off_c, p.t_2) if use == "C"
                        else (crs._off_d, p.t_1))
        w = _weights(q, p.kappa_2, 3)
        got = full_limb_model(
            crs, alpha_cd_offset(base, t_used, p.t_1, p.kappa_2), w,
            n_tri * t_used)
        want = alpha_cuda.alpha_cd_plain(crs, base, w, t_used)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG])
def test_full_limb_model_across_flushes(q):
    """The A pass over kappa = 256 rows: two flush periods of 128 at big q
    (one of 256 at small q), entries and weights drawn, against the plain
    version."""
    p = _params("config1", q, kappa_override=256)
    crs = CRS.create(p, SEED)
    w = _weights(q, p.kappa, 4)
    got = full_limb_model(crs, alpha_a_offset(p.n), w, p.n)
    assert torch.equal(got, alpha_cuda.alpha_a_plain(crs, w))


def test_dispatch_counts_the_plain_route():
    """On the CPU every pass takes the plain version: no kernel launch
    counts, and the result is the plain version's."""
    p = _params("config1", Q_SMALL, kappa_override=16)
    crs = CRS.create(p, SEED)
    w = _weights(p.q, p.kappa, 5)
    launches = alpha_cuda.KERNEL.launches + alpha_cuda.KERNEL_BIG.launches
    got = recursion._alpha_contract_a(crs, w, p)
    assert (alpha_cuda.KERNEL.launches + alpha_cuda.KERNEL_BIG.launches
            == launches)
    assert torch.equal(got, alpha_cuda.alpha_a_plain(crs, w))

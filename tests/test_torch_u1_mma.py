"""The arithmetic of the tensor-core stream kernel of the u1 B-term and
the C/D sums (``csrc/mma_stream.cuh``, with the offsets of ``csrc/u1.cu``
and ``csrc/cd.cu``), modelled on the CPU.

* The Barrett reduction of the 64-bit Threefry words (``barrett_mod`` in
  ``csrc/threefry.cuh``, shared with the Ajtai and C/D kernels), step by
  step in Python integers with the kernel's 64-bit wrap, equals x mod q
  on seeded random words and on the edge words.
* A torch model of the kernel's limb scheme (entries as unsigned 8-bit
  limbs of the residue, digits as signed 8-bit limbs, int32 sums per limb
  weight between flushes, recombination mod q) is bit-equal to the plain
  version at the config-1 shapes, at q = 8191 and at both big moduli,
  with CRS entries drawn and forced to 0, q - 1, q/2 and q/2 + 1; and
  with the C/D offsets (the D-term over t_1, the C-term over t_2 < t_1,
  where the offset is not affine in the stream index), digits at +-b/2 of
  their base, bit-equal to ``cd_sum_plain``.
* The wrappers' digit-range check raises for a digit beyond its limbs,
  the C/D wrapper's too.

On a CUDA machine, also the kernel in each of its digit-limb modes
against the plain version, at the folded kappa_1 = 16 shape with digits
at the largest magnitude the limbs hold.
"""

import numpy as np
import pytest
import torch

from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.ops import cd_cuda, u1_cuda
from labrador_tpu_torch.ops.modmath import mod_pos, mulmod
from labrador_tpu_torch.ops.ring_stream import (barrett_m, circulant,
                                                ring_stream_plain)
from labrador_tpu_torch.ops.zq import to_signed_small
from labrador_tpu_torch.params import LabradorParams
from labrador_tpu_torch.protocol import _tri_stream

Q_SMALL, Q_BIG, Q_TOP = 8191, 4294967311, 8589934583
MODULI = [Q_SMALL, Q_BIG, Q_TOP]
M64 = (1 << 64) - 1
SEED = 0x5EED


def _params(q: int) -> LabradorParams:
    """Config 1 (n = r = 2) at modulus q."""
    if q == Q_SMALL:
        return LabradorParams(n=2, r=2)
    start = (1 << 32) - 1 if q == Q_BIG else (1 << 33) - 9
    return LabradorParams(n=2, r=2, q_start=start, exact_digits=True)


@pytest.mark.parametrize("q", MODULI)
def test_params_moduli(q):
    assert _params(q).q == q


def barrett_mod_model(x: int, q: int, m: int) -> int:
    """``barrett_mod`` step by step on one 64-bit word, in Python integers
    with the kernel's 64-bit wrap: the high word of x * m, the wrapping
    x - t * q, one conditional subtraction.  Raises if the remainder before
    the subtraction is not below 2q (the bound the kernel relies on)."""
    mask = (1 << 64) - 1
    t = (x * m) >> 64
    r = (x - ((t * q) & mask)) & mask
    if r >= 2 * q:
        raise AssertionError(f"Barrett remainder {r} >= 2q for x = {x}")
    return r - q if r >= q else r


@pytest.mark.parametrize("q", MODULI)
def test_barrett_matches_mod(q):
    m = barrett_m(q)
    assert m == M64 // q
    rng = np.random.default_rng(SEED)
    words = [int(x) for x in rng.integers(0, 1 << 64, 100_000,
                                          dtype=np.uint64)]
    k_top = M64 // q
    edges = [0, 1, q - 1, q, q + 1, M64, M64 - 1]
    for k in (k_top - 1, k_top):
        edges += [k * q - 1, k * q, k * q + 1]
    edges = [x for x in edges if 0 <= x <= M64]
    for x in words + edges:
        assert barrett_mod_model(x, q, m) == x % q, x


def _u8_limbs(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Unsigned 8-bit limbs of residues (the kernel's pack_entry_limbs)."""
    out = [(x >> (8 * k)) & 255 for k in range(n)]
    assert torch.equal(sum(l << (8 * k) for k, l in enumerate(out)), x)
    return out


def _s8_limbs(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Signed 8-bit limbs, as the kernel builds its circulant words."""
    out, v = [], x
    for _ in range(n):
        limb = ((v + 128) & 255) - 128
        out.append(limb)
        v = (v - limb) >> 8
    assert torch.equal(v, torch.zeros_like(v)), "digit beyond its limbs"
    return out


def limb_model(draw, stream: torch.Tensor, rows: int, q: int,
               n_limbs: int) -> torch.Tensor:
    """(rows, d) mod q: what the kernel computes, in its limbs.  Per flush
    period of FLUSH_L ring elements, the int32 sum of each limb weight
    w = a + b over entry limb a and digit limb b (float64 products, exact
    below 2^53), asserted inside int32; then sum_w (2^(8w) mod q) S_w
    mod q."""
    L, d = stream.shape
    el = u1_cuda.entry_limbs(q)
    dig_c = to_signed_small(stream, q)
    res = torch.zeros((rows, d), dtype=torch.int64)
    for l0 in range(0, L, u1_cuda.FLUSH_L):
        l1 = min(L, l0 + u1_cuda.FLUSH_L)
        m = draw(l0, l1).reshape(rows, (l1 - l0) * d)
        assert int(m.min()) >= 0 and int(m.max()) < q
        circ = circulant(dig_c[l0:l1]).reshape((l1 - l0) * d, d)
        em = [x.double() for x in _u8_limbs(m, el)]
        dm = [x.double() for x in _s8_limbs(circ, n_limbs)]
        sums = [torch.zeros((rows, d), dtype=torch.int64)
                for _ in range(el + n_limbs - 1)]
        for a in range(el):
            for b in range(n_limbs):
                sums[a + b] += (em[a] @ dm[b]).to(torch.int64)
        for w, s in enumerate(sums):
            assert int(s.min()) >= -(1 << 31) and int(s.max()) < 1 << 31
            res = mod_pos(res + mulmod(mod_pos(s, q), (1 << (8 * w)) % q, q),
                          q)
    return res


def _digits(p, rng, extreme: bool) -> torch.Tensor:
    """t digits (t_1, r, kappa, d): residues at small q, signed at big q;
    at +-b_1/2 only, or uniform in [-b_1/2, b_1/2] with both ends in."""
    h = p.b_1 // 2
    shape = (p.t_1, p.r, p.kappa, p.d)
    if extreme:
        x = rng.choice([-h, h], shape)
    else:
        x = rng.integers(-h, h + 1, shape)
        x.reshape(-1)[:2] = [h, -h]
    return torch.from_numpy(x if p.q > Q_SMALL else x % p.q)


def _forced(kind: str, q: int):
    """Entries forced to 0, q - 1, q/2, q/2 + 1 in turn ("cycle"), or all
    q - 1 (every entry limb at its largest)."""
    vals = torch.tensor([0, q - 1, q // 2, q // 2 + 1], dtype=torch.int64)

    def draw(rows: int, l0: int, l1: int) -> torch.Tensor:
        if kind == "max":
            return torch.full((rows, l1 - l0, 64), q - 1, dtype=torch.int64)
        idx = (torch.arange(rows)[:, None, None]
               + torch.arange(l0, l1)[None, :, None]
               + torch.arange(64)[None, None, :])
        return vals[idx % 4]
    return draw


@pytest.mark.parametrize("entries", ["crs", "cycle", "max"])
@pytest.mark.parametrize("q", MODULI)
def test_limb_model_matches_plain(q, entries):
    p = _params(q)
    rng = np.random.default_rng(q % 1000 + len(entries))
    t_dig = _digits(p, rng, extreme=entries != "crs")
    stream = u1_cuda._stream(t_dig, p)[0]
    n_limbs = u1_cuda.digit_limbs(p.b_1)
    assert n_limbs == (1 if q == Q_SMALL else 2)
    u1_cuda.check_digit_range(t_dig, q, n_limbs)
    if entries == "crs":
        crs = CRS.create(p, SEED)
        want = u1_cuda.u1_bterm_plain(crs, t_dig)
        kd = p.kappa * p.d

        def draw(l0, l1):
            lin = torch.arange(l0, l1)
            col = (lin // p.kappa) * (p.kappa_1 * p.kappa) \
                + (lin % p.kappa) * p.d
            offs = (crs._off_b + (torch.arange(p.kappa_1) * kd)[:, None, None]
                    + col[None, :, None] + torch.arange(p.d)[None, None, :])
            return crs.draw(offs)
    else:
        forced = _forced(entries, q)

        def draw(l0, l1):
            return forced(p.kappa_1, l0, l1)
        want = ring_stream_plain(draw, stream[None], p.kappa_1, q)[0]
    got = limb_model(draw, stream, p.kappa_1, q, n_limbs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("use", ["D", "C"])
@pytest.mark.parametrize("q", MODULI)
def test_cd_limb_model_matches_plain(q, use):
    """The C/D offsets through the limb model: the D-term (h digits of
    base b_1 over t_1) and the C-term (g digits of base b_2 over t_2 <
    t_1), digits at +-b/2 only, against cd_sum_plain."""
    p = _params(q)
    crs = CRS.create(p, SEED)
    base_off, t_used, b = ((crs._off_d, p.t_1, p.b_1) if use == "D"
                           else (crs._off_c, p.t_2, p.b_2))
    if use == "C":
        assert t_used < p.t_1
    h = b // 2
    rng = np.random.default_rng(q % 997 + t_used)
    x = rng.choice([-h, h], (t_used, p.r, p.r, p.d))
    stream = _tri_stream(torch.from_numpy(x if q > Q_SMALL else x % q), p)
    n_limbs = cd_cuda.stream_digit_limbs(crs, b)
    assert n_limbs == (1 if q == Q_SMALL else 2)
    u1_cuda.check_digit_range(stream, q, n_limbs)

    def draw(l0, l1):
        lin = torch.arange(l0, l1)
        oc = (lin // t_used) * p.t_1 + lin % t_used
        offs = (base_off + oc[None, :, None] * (p.kappa_2 * p.d)
                + (torch.arange(p.kappa_2) * p.d)[:, None, None]
                + torch.arange(p.d)[None, None, :])
        return crs.draw(offs)

    want = cd_cuda.cd_sum_plain(crs, stream, base_off, t_used)
    got = limb_model(draw, stream.reshape(-1, p.d), p.kappa_2, q, n_limbs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG])
def test_cd_digit_range_check_raises(q):
    """The C/D wrapper's check, on the CPU: the limb count of the C-term's
    base, and the raise after a launch whose kernel flagged a digit one
    beyond what those limbs hold (the flag a CPU tensor here)."""
    p = _params(q)
    crs = CRS.create(p, SEED)
    n_limbs = cd_cuda.stream_digit_limbs(crs, p.b_2)
    assert n_limbs == u1_cuda.digit_limbs(p.b_2)
    top = u1_cuda.limb_cover(n_limbs)
    stream = torch.zeros((3, p.t_2, p.d), dtype=torch.int64)
    stream[1, 0, 5] = top
    clear, flagged = torch.zeros(1, dtype=torch.int32), \
        torch.ones(1, dtype=torch.int32)
    u1_cuda.raise_if_flagged(clear, stream % q, q, n_limbs)
    stream[2, 1, 7] = -top - 1
    with pytest.raises(ValueError, match="beyond"):
        u1_cuda.raise_if_flagged(flagged, stream % q, q, n_limbs)
    with pytest.raises(ValueError, match="no u1 kernel mode"):
        cd_cuda.stream_digit_limbs(crs, 1 << 40)


@pytest.mark.parametrize("q, n_limbs", [(Q_SMALL, 1), (Q_BIG, 1),
                                        (Q_BIG, 2), (Q_TOP, 3), (Q_BIG, 4)])
def test_digit_range_check(q, n_limbs):
    """Digits at +-limb_cover pass; one beyond raises, residues (small q)
    and signed values (big q) alike."""
    top = u1_cuda.limb_cover(n_limbs)
    ok = torch.tensor([top, -top, 0], dtype=torch.int64)
    u1_cuda.check_digit_range(ok % q, q, n_limbs)
    u1_cuda.check_digit_range(ok, q, n_limbs)
    for bad in (top + 1, -top - 1):
        with pytest.raises(ValueError, match="beyond"):
            u1_cuda.check_digit_range(
                torch.tensor([0, bad], dtype=torch.int64) % q, q, n_limbs)
    assert _s8_limbs(ok, n_limbs)                 # the split holds +-top


@pytest.mark.parametrize("q, n_limbs", [(Q_SMALL, 3), (Q_BIG, 5),
                                        (Q_BIG, 0)])
def test_digit_range_check_no_mode(q, n_limbs):
    with pytest.raises(ValueError, match="no u1 kernel mode"):
        u1_cuda.check_digit_range(torch.zeros(3, dtype=torch.int64), q,
                                  n_limbs)


@pytest.mark.parametrize("b", [2, 4, 9, 254, 255, 256, 1625, 2047, 65278,
                               65279, 65536, 8191])
def test_digit_limbs_cover(b):
    """digit_limbs(b) is the least count whose limbs hold +-b/2."""
    n = u1_cuda.digit_limbs(b)
    assert u1_cuda.limb_cover(n) >= b // 2
    assert n == 1 or u1_cuda.limb_cover(n - 1) < b // 2


@pytest.mark.parametrize("rows, L", [(256, 24576), (256, 16384), (16, 37440),
                                     (16, 10800), (128, 1024), (16, 720),
                                     (12, 5), (16, 211770), (16, 45900),
                                     (256, 816), (24, 100)])
def test_launch_shape_covers_stream(rows, L):
    tiles, groups, splits, per = u1_cuda.launch_shape(rows, L)
    assert 1 <= tiles * groups <= 8 and per % 16 == 0
    assert groups == 1 or tiles <= 4
    assert (splits - 1) * per < L <= splits * per
    assert -(-rows // (8 * tiles)) * tiles * 8 >= rows


@pytest.mark.cuda
@pytest.mark.parametrize("q, b_1", [(Q_SMALL, 9), (Q_SMALL, 8191),
                                    (Q_BIG, 2), (Q_BIG, 1625),
                                    (Q_BIG, 65536), (Q_TOP, 1 << 24)])
def test_cuda_u1_digit_modes_match_plain(q, b_1):
    """Each digit-limb mode of the kernel at the folded kappa_1 = 16 shape,
    digits at the largest magnitude the limbs hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = LabradorParams(n=13, r=15, q=q, k_count=51, l_count=1,
                       kappa_override=16, exact_digits=True)
    object.__setattr__(p, "b_1", b_1)         # the digit-limb mode
    n_limbs = u1_cuda.digit_limbs(b_1)
    top = min(b_1 // 2, u1_cuda.limb_cover(n_limbs))
    rng = np.random.default_rng(b_1)
    x = rng.choice([-top, top, 0, 1], (p.t_1, p.r, p.kappa, p.d))
    t_dig = torch.from_numpy(x if q > Q_SMALL else x % q).to("cuda")
    crs = CRS.create(p, SEED)
    got = u1_cuda.u1_bterm(crs, t_dig)
    want = u1_cuda.u1_bterm_plain(crs, t_dig)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

"""The arithmetic of the two tensor-core kernels of ``csrc/polymul.cu``
(the bhat variant of kernel 1) and ``csrc/ajtai.cu`` (the Ajtai
commitment), modelled on the CPU with no GPU and no JAX.

* bhat: a torch model that reads the wrapper's own tables back out of
  their B-fragment words (``polymul_cuda.bhat_tables``, the PTX layout of
  mma.m16n8k32) and the wrapper's constants (``bhat_consts``), builds the A
  operand from the kernel's column formula, sums each limb weight of both
  transforms in int32 (asserted), and reduces, multiplies and folds with
  the kernel's Barrett steps (the bound before each conditional
  subtraction asserted): bit-equal to ``negacyclic_polymul_bhat_plain`` on
  random and edge residues (0 and p - 1 in a and in bhat), signed and
  out-of-range a, a fixed one-row and a per-row bhat.  The Barrett
  constants against ``%`` on every prime of the plans at q = 8191 and
  q = 32513.
* Ajtai: a torch model of the limb scheme (entries as unsigned 8-bit
  limbs, the centred witness as signed ones, 2 and 2 at small q, 5 and 5
  at big q, int32 sums per limb weight asserted at every flush of
  ``FLUSH_L`` ring elements, recombination mod q): bit-equal to
  ``ajtai_commit_plain`` at small q and at q = 4294967311 and 8589934583,
  with r_eff in {1, 3, 16}, witness values at +-q/2 and in the band
  (2,139,062,143, q/2] that four signed limbs cannot hold, and entries all
  at q - 1 over more than two flush periods.
* The Ajtai launch shape covers the stream for r_eff = 1 and for r_eff
  not a multiple of its rhs group.
"""

import numpy as np
import pytest
import torch

from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.ops import ajtai_cuda, ntt, polymul_cuda
from labrador_tpu_torch.ops.modmath import mod_pos, mulmod
from labrador_tpu_torch.ops.ring_stream import circulant, ring_stream_plain
from labrador_tpu_torch.ops.zq import to_signed_small
from labrador_tpu_torch.params import LabradorParams

Q_SMALL, Q_BIG, Q_TOP = 8191, 4294967311, 8589934583
INT32_MAX = (1 << 31) - 1
FOUR_LIMB_COVER = 127 * (256**4 - 1) // 255          # 2,139,062,143


def _plans():
    return [ntt.plan_for(LabradorParams(n=2, r=2)), ntt.make_plan(8191),
            ntt.make_plan(32513)]


# ---------------------------------------------------------------------------
# bhat
# ---------------------------------------------------------------------------

def barrett32_lazy(x: torch.Tensor, p, m) -> torch.Tensor:
    """csrc/polymul.cu barrett32_lazy on int64 tensors holding uint32
    values: asserts x < 2^32 and the result in [0, 2p)."""
    assert int(x.min()) >= 0 and int(x.max()) < 1 << 32
    r = x - ((x * m) >> 32) * p
    assert bool(torch.all((r >= 0) & (r < 2 * p)))
    return r


def barrett32(x: torch.Tensor, p, m) -> torch.Tensor:
    """csrc/polymul.cu barrett32: the lazy step and one subtraction."""
    r = barrett32_lazy(x, p, m)
    return torch.where(r >= p, r - p, r)


def res_mod_model(x: int, p: int, m64: int) -> int:
    """csrc/polymul.cu res_mod in Python integers with the kernel's 64-bit
    wrap."""
    if -p <= x < p:
        return x + p if x < 0 else x
    mask = (1 << 64) - 1
    u = (-x) & mask if x < 0 else x
    r = (u - ((((u * m64) >> 64) * p) & mask)) & mask
    assert r < 2 * p
    if r >= p:
        r -= p
    return p - r if x < 0 and r else r


def _b_matrices(words: np.ndarray) -> np.ndarray:
    """Fragment words (2, 8, 2, 32, 2) of one transform and prime -> the
    logical B limb matrices (limb, k-step, k, n) by the PTX layout of
    mma.m16n8k32's B: register b_i byte j of lane (g, t) is B[16 i + 4 t +
    j][g] of n-tile nt."""
    out = np.zeros((2, 2, 32, 64), np.int64)
    w = words.astype(np.int64)
    for s in range(2):
        for nt in range(8):
            for limb in range(2):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for bi in range(2):
                        for j in range(4):
                            out[limb, s, 16 * bi + 4 * t + j, 8 * nt + g] = \
                                (w[s, nt, limb, lane, bi] >> (8 * j)) & 255
    return out


def _a_columns() -> np.ndarray:
    """(2, 32): the column of a in logical k of k-step s, from the kernel's
    packing: lane (g, t) register 2 hp + rh byte 2 pp + e holds column 32 s
    + 16 hp + 8 pp + 2 t + e, and the PTX layout puts register r byte j at
    k = 4 t + j + 16 (r >> 1)."""
    cols = np.zeros((2, 32), np.int64)
    for s in range(2):
        for hp in range(2):
            for t in range(4):
                for pp in range(2):
                    for e in range(2):
                        cols[s, 16 * hp + 4 * t + 2 * pp + e] = \
                            32 * s + 16 * hp + 8 * pp + 2 * t + e
    assert np.array_equal(cols, polymul_cuda.bhat_k_order())
    return cols


def _transform(x: torch.Tensor, bmat: np.ndarray, cols: np.ndarray, p: int,
               m: int) -> torch.Tensor:
    """One transform of (rows, 64) values in [0, 2p) as the kernel takes
    it: limb weights S0, S1, S2 summed in int32 (asserted), then
    weights_mod's two lazy steps: a result in [0, 2p)."""
    lo, hi = (x & 255).double(), (x >> 8).double()
    assert int(x.min()) >= 0 and int(x.max()) < 2 * p
    s = [torch.zeros((x.shape[0], 64), dtype=torch.int64) for _ in range(3)]
    for st in range(2):
        a = [lo[:, cols[st]], hi[:, cols[st]]]
        b = [torch.from_numpy(bmat[limb, st]).double() for limb in range(2)]
        for la in range(2):
            for lb in range(2):
                s[la + lb] += (a[la] @ b[lb]).to(torch.int64)
    for sw in s:
        assert int(sw.min()) >= 0 and int(sw.max()) <= INT32_MAX
    w = barrett32_lazy(s[1] + (s[2] << 8), p, m)
    return barrett32_lazy(s[0] + (w << 8), p, m)


def _scaled(bmat: np.ndarray, cols: np.ndarray, bh: np.ndarray,
            p: int) -> np.ndarray:
    """W's limb matrices with row k scaled by bhat[k] mod p (the kernel's
    W' for a fixed operand)."""
    out = np.zeros_like(bmat)
    for s in range(2):
        e = bmat[0, s] + 256 * bmat[1, s]
        v = e * bh[cols[s]][:, None] % p
        out[0, s], out[1, s] = v & 255, v >> 8
    return out


def bhat_model(a: torch.Tensor, bhat: torch.Tensor, plan) -> torch.Tensor:
    """(n, 64) mod q: what polymul_bhat_kernel computes, step by step."""
    P = plan.n_primes
    tables = polymul_cuda.bhat_tables(plan)
    c = polymul_cuda.bhat_consts(plan)
    pr, m32, m64 = c[:P], c[P:2 * P], c[2 * P:3 * P]
    gi = c[3 * P:3 * P + P * P]
    mh = c[3 * P + P * P:4 * P + P * P]
    pre = c[4 * P + P * P:5 * P + P * P]
    m_mod_q, q, m32q = c[5 * P + P * P:]
    cols = _a_columns()
    n = a.shape[0]
    bh = torch.broadcast_to(bhat, (P, n, 64))
    res = []
    fixed = bhat.shape[1] == 1
    for pi in range(P):
        p, m = pr[pi], m32[pi]
        x = mod_pos(a, p)
        xh = _transform(x, _b_matrices(tables[0, pi]), cols, p, m)
        w_mat = _b_matrices(tables[1, pi])
        if fixed:
            w_mat = _scaled(w_mat, cols, mod_pos(bh[pi, 0], p).numpy(), p)
            y = xh
        else:
            y = barrett32_lazy(xh * mod_pos(bh[pi], p), p, m)
        res.append(_transform(y, w_mat, cols, p, m))
    v = [torch.where(res[0] >= pr[0], res[0] - pr[0], res[0])]
    for k in range(1, P):
        p, m = pr[k], m32[k]
        t = res[k] + 2 * p - v[0]
        for j in range(1, k):
            t = barrett32_lazy(t * gi[(j - 1) * P + k], p, m) + 2 * p - v[j]
        v.append(barrett32(t * gi[(k - 1) * P + k], p, m))
    # one reduction at the end where P * 2^15 * q < 2^32, else per term
    one_reduce = P * 32768 * 32513 < 1 << 32
    acc = torch.zeros_like(v[0])
    gt = torch.zeros_like(v[0], dtype=torch.bool)
    for j in range(P):
        acc = acc + v[j] * pre[j]
        if not one_reduce:
            acc = barrett32(acc, q, m32q)
        gt = (v[j] > mh[j]) | ((v[j] == mh[j]) & gt)
    if one_reduce:
        acc = barrett32(acc, q, m32q)
    acc = acc + torch.where(gt, q - m_mod_q, 0)
    return torch.where(acc >= q, acc - q, acc)


@pytest.mark.parametrize("plan", _plans(), ids=["plan_for", "8191", "32513"])
def test_bhat_barrett_constants(plan):
    """barrett32 with floor(2^32 / p) and res_mod with floor((2^64 - 1) /
    p) against % on every prime of the plan and on q."""
    c = polymul_cuda.bhat_consts(plan)
    P = plan.n_primes
    assert c[:P] == list(plan.primes)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.integers(0, 1 << 32, 200_000))
    for p, m in [*zip(c[:P], c[P:2 * P]), (plan.q, c[-1])]:
        assert (1 << 14) < p < (1 << 15) or p == plan.q
        edges = torch.tensor([0, 1, p - 1, p, p + 1, 2 * p - 1,
                              (1 << 32) - 1, (1 << 32) - p,
                              ((1 << 32) // p) * p - 1,
                              ((1 << 32) // p) * p], dtype=torch.int64)
        for x in (xs, edges):
            assert torch.equal(barrett32(x, p, m), x % p)
    words = [0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 40, -(1 << 40) - 3]
    words += [int(x) for x in rng.integers(-(1 << 63), (1 << 63) - 1, 2000,
                                           dtype=np.int64)]
    for p, m64 in zip(c[:P], c[2 * P:3 * P]):
        for x in words + [p - 1, p, -p, -p - 1]:
            assert res_mod_model(x, p, m64) == x % p


def _bhat_inputs(plan, kind: str, n: int, rng):
    P, q = plan.n_primes, plan.q
    pv = np.asarray(plan.primes).reshape(P, 1, 1)
    a = rng.integers(0, q, (n, 64))
    if kind in ("edges", "fixed_edges"):
        # 0 and p - 1 in a (q - 1 < every p: the residue bound of a) and
        # in bhat, per prime
        a[: n // 2] = rng.choice([0, q - 1], (n // 2, 64))
        rows = 1 if kind == "fixed_edges" else n
        bhat = rng.choice([0, 1], (P, rows, 64)) * (pv - 1)
    elif kind == "signed":
        a = rng.integers(-(1 << 62), 1 << 62, (n, 64))
        a[0, :4] = [-(1 << 63), (1 << 63) - 1, -q + 1, -1]
        bhat = rng.integers(0, 1 << 62, (P, n, 64)) % pv
    else:
        bhat = rng.integers(0, 1 << 62, (P, n, 64)) % pv
    if kind == "fixed":
        bhat = ntt.ntt_fwd(torch.from_numpy(rng.integers(0, q, (1, 64))),
                           plan).numpy()
    return torch.from_numpy(a), torch.from_numpy(np.asarray(bhat))


@pytest.mark.parametrize("kind", ["fixed", "fixed_edges", "per_row", "edges",
                                  "signed"])
@pytest.mark.parametrize("plan", _plans()[::2], ids=["plan_for", "32513"])
def test_bhat_model_matches_plain(plan, kind):
    rng = np.random.default_rng(len(kind) + plan.n_primes)
    a, bhat = _bhat_inputs(plan, kind, 37, rng)
    want = polymul_cuda.negacyclic_polymul_bhat_plain(a, bhat, plan)
    assert torch.equal(bhat_model(a, bhat, plan), want)


def test_bhat_tables_layout():
    """The fragment words decode to V and W with their rows in the kernel's
    K order, low and high bytes of every residue."""
    plan = ntt.make_plan(8191)
    tables = polymul_cuda.bhat_tables(plan)
    cols = polymul_cuda.bhat_k_order()
    for ti, t in enumerate((plan.V, plan.W)):
        for pi in range(plan.n_primes):
            b = _b_matrices(tables[ti, pi])
            for s in range(2):
                assert np.array_equal(b[0, s] + 256 * b[1, s],
                                      np.asarray(t[pi])[cols[s]])


# ---------------------------------------------------------------------------
# Ajtai
# ---------------------------------------------------------------------------

def _u8_limbs(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    out = [(x >> (8 * k)) & 255 for k in range(n)]
    assert torch.equal(sum(l << (8 * k) for k, l in enumerate(out)), x)
    return out


def _s8_limbs(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    out, v = [], x
    for _ in range(n):
        limb = ((v + 128) & 255) - 128
        out.append(limb)
        v = (v - limb) >> 8
    assert torch.equal(v, torch.zeros_like(v)), "witness beyond its limbs"
    return out


def ajtai_limb_model(draw, w: torch.Tensor, rows: int, q: int):
    """(r_eff, rows, d) mod q: what ajtai_mma_kernel computes, in its
    limbs.  Per flush period of FLUSH_L ring elements, the int32 sum of
    each limb weight (entry limb + witness limb; float64 products, exact
    below 2^53) asserted inside int32; then sum_w (2^(8w) mod q) S_w."""
    r_eff, L, d = w.shape
    el, wl = ajtai_cuda.entry_limbs(q), ajtai_cuda.witness_limbs(q)
    w_c = to_signed_small(w, q)
    res = torch.zeros((r_eff, rows, d), dtype=torch.int64)
    for l0 in range(0, L, ajtai_cuda.FLUSH_L):
        l1 = min(L, l0 + ajtai_cuda.FLUSH_L)
        m = draw(l0, l1).reshape(1, rows, (l1 - l0) * d)
        assert int(m.min()) >= 0 and int(m.max()) < q
        circ = circulant(w_c[:, l0:l1]).reshape(r_eff, (l1 - l0) * d, d)
        em = [x.double() for x in _u8_limbs(m, el)]
        wm = [x.double() for x in _s8_limbs(circ, wl)]
        sums = [torch.zeros((r_eff, rows, d), dtype=torch.int64)
                for _ in range(el + wl - 1)]
        for ea in range(el):
            for b in range(wl):
                sums[ea + b] += (em[ea] @ wm[b]).to(torch.int64)
        for wt, s in enumerate(sums):
            assert int(s.min()) >= -(1 << 31) and int(s.max()) <= INT32_MAX
            res = mod_pos(res + mulmod(mod_pos(s, q), (1 << (8 * wt)) % q, q),
                          q)
    return res


def _ajtai_params(q: int, r: int) -> LabradorParams:
    if q == Q_SMALL:
        return LabradorParams(n=2, r=r)
    start = (1 << 32) - 1 if q == Q_BIG else (1 << 33) - 9
    return LabradorParams(n=2, r=r, q_start=start, exact_digits=True)


def _witness(q: int, shape, rng) -> torch.Tensor:
    """Residues at small q; at big q signed values over [-q/2, q/2] with
    +-q/2, +-(four-limb cover + 1) and the band above that cover present,
    and canonical residues up to q - 1 (centred by the kernel)."""
    if q == Q_SMALL:
        x = rng.integers(0, q, shape)
        x.reshape(-1)[:3] = [0, q - 1, q // 2]
        return torch.from_numpy(x)
    h = q // 2
    x = rng.integers(-h, h + 1, shape)
    band = rng.integers(FOUR_LIMB_COVER + 1, h + 1, x.size // 4)
    x.reshape(-1)[: band.size] = band * rng.choice([-1, 1], band.size)
    x.reshape(-1)[-6:] = [h, -h, FOUR_LIMB_COVER + 1, -FOUR_LIMB_COVER - 1,
                          q - 1, h + 1]
    return torch.from_numpy(x)


@pytest.mark.parametrize("r_eff", [1, 3, 16])
@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG, Q_TOP])
def test_ajtai_limb_model_matches_plain(q, r_eff):
    p = _ajtai_params(q, max(r_eff, 2))
    assert p.q == q
    crs = CRS.create(p, 0xA17A1 + r_eff)
    w = _witness(q, (r_eff, p.n, p.d), np.random.default_rng(q % 991 + r_eff))
    nd = p.n * p.d

    def draw(l0, l1):
        return crs._expand_dyn(l0 * p.d, 0, 0, (p.kappa, l1 - l0, p.d),
                               (nd, p.d, 1), device="cpu")

    want = ajtai_cuda.ajtai_commit_plain(crs, w)
    assert torch.equal(ajtai_limb_model(draw, w, p.kappa, q), want)


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG, Q_TOP])
def test_ajtai_limb_model_worst_case_flush(q):
    """Entries all q - 1 (every entry limb at its largest) against a
    witness at +-q/2 over 300 ring elements, more than two flush periods:
    the int32 bound of each weight holds and the result equals the plain
    contraction."""
    L, rows = 300, 8
    h = q // 2
    rng = np.random.default_rng(q % 1009)
    x = rng.choice([-h, h], (3, L, 64))
    w = torch.from_numpy(x if q > Q_SMALL else x % q)

    def draw(l0, l1):
        return torch.full((rows, l1 - l0, 64), q - 1, dtype=torch.int64)

    want = ring_stream_plain(draw, w, rows, q)
    assert torch.equal(ajtai_limb_model(draw, w, rows, q), want)


def test_ajtai_limb_counts():
    """Four signed limbs stop short of q/2 at every big q; five hold it,
    and two hold q/2 at the largest small q."""
    assert FOUR_LIMB_COVER < Q_BIG // 2
    five = 127 * (256**5 - 1) // 255
    assert ajtai_cuda.witness_limbs(Q_BIG) == 5 and Q_TOP // 2 <= five
    assert ajtai_cuda.witness_limbs(Q_SMALL) == 2
    assert 32513 // 2 <= 127 * (256**2 - 1) // 255
    assert ajtai_cuda.entry_limbs(Q_TOP) == 5
    assert (Q_TOP - 1) >> 32 <= 1 and (32513 - 1) >> 16 == 0


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG])
@pytest.mark.parametrize("rows, nrhs, L", [
    (256, 16, 16), (256, 1, 16), (16, 180, 175), (16, 135, 132),
    (16, 1, 175), (16, 1, 132), (128, 2, 2), (128, 3, 5), (12, 7, 1),
    (256, 5, 1000), (8, 1, 1), (40, 13, 37)])
def test_ajtai_launch_shape_covers_stream(q, rows, nrhs, L):
    row_tiles, group, l_groups, splits, per = ajtai_cuda.launch_shape(
        rows, nrhs, L, q)
    ms = 4 // ajtai_cuda.m_tiles(q)
    assert 1 <= group <= nrhs and row_tiles >= 1 and l_groups >= 1
    assert row_tiles * group * ms * l_groups <= ajtai_cuda.max_warps(q)
    assert per % ajtai_cuda.chunk(q) == 0
    assert (splits - 1) * per < L <= splits * per and splits <= 65535
    assert -(-rows // (8 * row_tiles)) * row_tiles * 8 >= rows
    assert -(-nrhs // group) * group >= nrhs
    if nrhs == 1:
        assert l_groups * row_tiles * ms == ajtai_cuda.max_warps(q) \
            or row_tiles * 8 >= rows


@pytest.mark.parametrize("n_limbs", [2, 5])
def test_ajtai_limb_bias_trick(n_limbs):
    """The kernel's circulant limbs, bytes of v + 128 (256^DL - 1) / 255
    each XOR 0x80, equal the balanced split (_s8_limbs) for every |v|
    within the limbs' cover: q/2 at every modulus, the band above four
    limbs' cover, and the cover's ends."""
    cover = 127 * (256**n_limbs - 1) // 255
    bias = 128 * (256**n_limbs - 1) // 255
    top = min(cover, Q_TOP // 2)
    rng = np.random.default_rng(n_limbs)
    v = rng.integers(-top, top + 1, 20_000)
    edges = [0, 1, -1, 127, 128, -128, -129, cover, -cover, Q_SMALL // 2,
             -(Q_SMALL // 2), 32513 // 2]
    if n_limbs == 5:
        edges += [Q_BIG // 2, -(Q_BIG // 2), Q_TOP // 2, -(Q_TOP // 2),
                  FOUR_LIMB_COVER + 1, -FOUR_LIMB_COVER - 1]
    x = torch.from_numpy(np.concatenate([v, edges]))
    u = x + bias
    assert int(u.min()) >= 0 and int(u.max()) < 256**n_limbs
    for b, limb in enumerate(_s8_limbs(x, n_limbs)):
        assert torch.equal(((u >> (8 * b)) & 255) ^ 0x80, limb & 255)


def _barrett_mod(x: int, q: int, m: int) -> int:
    """threefry.cuh barrett_mod on a 64-bit word, the bound asserted."""
    mask = (1 << 64) - 1
    assert 0 <= x <= mask
    r = (x - ((((x * m) >> 64) * q) & mask)) & mask
    assert r < 2 * q
    return r - q if r >= q else r


@pytest.mark.parametrize("q", [Q_BIG, Q_TOP])
def test_ajtai_big_flush_model(q):
    """csrc/ajtai.cu BigFlush in Python integers: its constants, and
    res + sum_w 2^(8w) acc[w] mod q through the 128-bit split and the two
    Barrett steps, on random and extreme int32 sums (9 weights)."""
    m = ((1 << 64) - 1) // q
    cw = [1]
    for _ in range(8):
        cw.append(_barrett_mod(cw[-1] << 8, q, m))
    assert cw == [pow(2, 8 * w, q) for w in range(9)]
    r = _barrett_mod((1 << 64) - 1, q, m)
    c64 = 0 if r + 1 == q else r + 1
    assert c64 == pow(2, 64, q)
    rng = np.random.default_rng(q % 997)
    cases = [([(1 << 31) - 1] * 9, q - 1), ([-(1 << 31)] * 9, 0),
             ([-(1 << 31)] * 9, q - 1)]
    cases += [([int(a) for a in rng.integers(-(1 << 31), 1 << 31, 9)],
               int(rng.integers(0, q))) for _ in range(2000)]
    for acc, res in cases:
        v = res + sum(c * a for c, a in zip(cw, acc))
        hi, lo = v >> 64, v & ((1 << 64) - 1)      # two's complement split
        assert -9 <= hi <= 9
        t = hi * c64 + _barrett_mod(lo, q, m) + 32 * q
        assert 0 <= t < 1 << 63
        assert _barrett_mod(t, q, m) == (res + sum(
            (1 << (8 * w)) * a for w, a in enumerate(acc))) % q

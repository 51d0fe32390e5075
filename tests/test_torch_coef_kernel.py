"""The arithmetic of kernel 1's coefficient variant (``csrc/polymul.cu``
``polymul_coef_kernel``), modelled on the CPU with no GPU and no JAX.

* A torch model of the kernel, step by step: the rows it reads through
  the wrapper's own row geometry (``polymul_cuda.coef_operands``: data
  pointer, n_inner, outer and inner strides), the input reduction (one
  conditional add for x in [-q, q), the 64-bit Barrett reduction of
  ``res_mod`` elsewhere, then centring into [-h, h]), the int32 sums of
  the centred products per flush of ``coef_consts``'s F terms and the
  shifted Barrett reductions, each bound asserted: bit-equal to
  ``negacyclic_polymul_plain`` on the operands' residues mod q (the plain
  version takes |x| < q; on such operands also to the plain version
  itself), at q = 8191 (F = 64) and q = 32513 (F = 8), on int64 extremes,
  values outside [-q, q), zero rows, one product, a partial tile, each
  operand fixed, the fold's outer broadcast and operands the wrapper
  copies.
* ``coef_consts`` against the launcher's checks and ``%`` at every q the
  kernel takes.
* The stride helper: the main path's three ring-product shapes and config
  2 read in place (no copy), with the expected strides.
* The kernel's index maps: the sliding window of ext, the conversion's
  pairs and the warp-staged stores each cover what they must, once.
"""

import numpy as np
import pytest
import torch

from labrador_tpu_torch.ops import ntt, polymul_cuda
from labrador_tpu_torch.ops.modmath import P_MAX

D = 64
INT32_MAX = (1 << 31) - 1
COEF_TILE, COEF_THREADS = 32, 256             # csrc/polymul.cu


def _t(a, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

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


def centred_model(x: torch.Tensor, q: int, m64: int) -> torch.Tensor:
    """coef_centred: x itself for x in [-q, q), else res_mod's residue;
    then into [-h, h] by one add or subtraction of q."""
    fast = (x >= -q) & (x < q)
    r = x.clone()
    flat, slow = r.view(-1), (~fast).view(-1).nonzero().flatten().tolist()
    for i in slow:
        flat[i] = res_mod_model(int(flat[i]), q, m64)
    h = q // 2
    c = torch.where(r > h, r - q, torch.where(r < -h, r + q, r))
    assert int(c.abs().max()) <= h
    assert bool(torch.all(torch.remainder(c - x, q) == 0))
    return c


def barrett32_lazy(x: torch.Tensor, p: int, m: int) -> torch.Tensor:
    """csrc/polymul.cu barrett32_lazy: asserts x < 2^32 and the result in
    [0, 2p)."""
    assert int(x.min()) >= 0 and int(x.max()) < 1 << 32
    r = x - ((x * m) >> 32) * p
    assert bool(torch.all((r >= 0) & (r < 2 * p)))
    return r


def barrett32(x: torch.Tensor, p: int, m: int) -> torch.Tensor:
    r = barrett32_lazy(x, p, m)
    return torch.where(r >= p, r - p, r)


def kernel_rows(x: torch.Tensor, n: int, n_inner: int, outer: int,
                inner: int) -> torch.Tensor:
    """The n rows the kernel reads from x's data: row r = ro n_inner + ri
    at x's data pointer + ro outer + ri inner (elements)."""
    storage = torch.as_strided(x, (x.untyped_storage().nbytes() // 8,), (1,),
                               0)
    r = torch.arange(n)
    start = x.storage_offset() + (r // n_inner) * outer + (r % n_inner) * inner
    return storage[start[:, None] + torch.arange(D)[None, :]]


def coef_model(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """What polymul_coef_kernel computes for a and b, step by step."""
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    n = int(np.prod(shape[:-1], dtype=np.int64))
    a2, b2, (n_inner, ao, ai, bo, bi) = polymul_cuda.coef_operands(a, b,
                                                                   shape)
    flush, shift, m32, m64 = polymul_cuda.coef_consts(q)
    h = q // 2
    assert flush in (8, 16, 32, 64)
    assert flush * h * h <= INT32_MAX and 2 * flush * h * h + q <= 1 << 32
    assert shift % q == 0 and flush * h * h <= shift < flush * h * h + q
    for x, o, i in ((a2, ao, ai), (b2, bo, bi)):       # cp.async's 16 bytes
        assert x.data_ptr() % 16 == 0 and o % 2 == 0 and i % 2 == 0
    ca = centred_model(kernel_rows(a2, n, n_inner, ao, ai), q, m64)
    cb = centred_model(kernel_rows(b2, n, n_inner, bo, bi), q, m64)
    ext = torch.cat([-cb, cb], dim=1)                   # ext[m], m < 128
    i, k = torch.arange(D)[:, None], torch.arange(D)[None, :]
    terms = ca[:, :, None] * ext[:, k - i + D]         # (n, i, k)
    assert int(terms.abs().max()) <= h * h
    tot = torch.zeros((n, D), dtype=torch.int64)
    for f0 in range(0, D, flush):
        acc = terms[:, f0:f0 + flush].sum(1)            # int32 in the kernel
        assert int(acc.abs().max()) <= INT32_MAX
        x = acc + shift                                 # as uint32
        if flush == D:
            return barrett32(x, q, m32).reshape(shape)
        tot += barrett32_lazy(x, q, m32)
    assert int(tot.max()) < 1 << 32
    return barrett32(tot, q, m32).reshape(shape)


def _want(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """a (*) b mod q: the plain version on the operands' residues."""
    q = plan.q
    return polymul_cuda.negacyclic_polymul_plain(
        torch.remainder(a, q), torch.remainder(b, q), plan)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

KINDS = ["residues", "signed", "int64_extremes", "zero_rows", "n1",
         "partial_tile", "a_fixed", "b_fixed", "outer_broadcast",
         "transposed", "misaligned", "three_axes"]


def coef_inputs(q: int, kind: str, rng, device: str = "cpu") -> tuple:
    """(a, b) of one kind, numpy from the seed, as tensors on ``device``
    (the views, transposed or 8 bytes off, built there)."""
    def t(x):
        return _t(x, device)

    n = 1001 if kind == "partial_tile" else 75
    res = rng.integers(0, q, (n, D))
    signed = rng.integers(-q, q, (n, D))
    wide = rng.integers(-(1 << 63), (1 << 63) - 1, (n, D), dtype=np.int64)
    wide[0, :8] = [-(1 << 63), (1 << 63) - 1, -(1 << 63) + 1, -q - 1, q,
                   -q, q - 1, 1 << 62]
    if kind in ("residues", "partial_tile"):
        return t(res), t(rng.integers(0, q, (n, D)))
    if kind == "signed":
        return t(signed), t(res)
    if kind == "int64_extremes":
        return t(wide), t(wide[::-1])
    if kind == "zero_rows":
        z = res.copy()
        z[::3] = 0
        return t(z), t(wide[::-1] * (np.arange(n)[:, None] % 2))
    if kind == "n1":
        return t(wide[0]), t(signed[0])
    if kind == "a_fixed":
        return t(wide[1]), t(res)
    if kind == "b_fixed":
        return t(signed), t(wide[:1])
    if kind == "outer_broadcast":
        return t(wide[:16, None]), t(signed[None, :16])
    if kind == "transposed":
        return t(res.T.copy()).T, t(signed)
    if kind == "misaligned":
        flat = t(rng.integers(0, q, n * D + 1))
        return flat[1:].view(n, D), t(wide)
    assert kind == "three_axes"
    return (t(res[:16].reshape(4, 1, 4, D)),
            t(signed[:16].reshape(1, 4, 4, D)[:, :, :1]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q", [8191, P_MAX])
def test_coef_model_matches_plain(q, kind):
    plan = ntt.make_plan(q)
    a, b = coef_inputs(q, kind, np.random.default_rng(q + len(kind)))
    got = coef_model(a, b, q)
    want = _want(a, b, plan)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    if kind in ("residues", "signed", "partial_tile", "transposed",
                "three_axes"):                  # |x| < q: the plain version
        assert torch.equal(got, polymul_cuda.negacyclic_polymul_plain(
            a, b, plan))


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [2, 3, 8191, 11585, 11587, 12289, P_MAX])
def test_coef_consts(q):
    """F per q, the launcher's checks (coef_args_ok), and the Barrett
    constants against % on the values the kernel reduces."""
    flush, shift, m32, m64 = polymul_cuda.coef_consts(q)
    h = q // 2
    fh2 = flush * h * h
    want_flush = {8191: 64, 11585: 64, 11587: 32, 12289: 32, P_MAX: 8}
    assert flush == want_flush.get(q, 64)
    assert fh2 < 1 << 31 and 2 * fh2 + q <= 1 << 32
    if flush > 8:            # the next longer flush would break a bound
        f2 = 2 * flush * h * h
        assert flush == 64 or f2 > INT32_MAX or 2 * f2 + q > 1 << 32
    assert shift % q == 0 and fh2 <= shift < fh2 + q
    assert m32 == (1 << 32) // q and m64 == ((1 << 64) - 1) // q
    x = torch.from_numpy(np.random.default_rng(q).integers(
        0, (1 << 32) - 1, 4096, dtype=np.int64))
    x[:3] = torch.tensor([0, shift, shift + fh2])
    assert torch.equal(barrett32(x, q, m32), torch.remainder(x, q))
    for v in (-(1 << 63), (1 << 63) - 1, -q - 1, q, 1 << 40, -(1 << 40)):
        assert res_mod_model(v, q, m64) == v % q


def test_no_flush_at_the_reference_modulus():
    """q = 8191: 64 h^2 = 1,073,217,600 < 2^31, one int32 sum a product;
    P_MAX = 32513: 8 h^2 = 2,114,060,288 < 2^31 <= 9 h^2."""
    assert polymul_cuda.coef_consts(8191)[0] == 64
    assert 64 * 4095**2 == 1_073_217_600 < 1 << 31
    assert polymul_cuda.coef_consts(P_MAX)[0] == 8
    assert 8 * 16256**2 == 2_114_060_288 < 1 << 31 <= 9 * 16256**2


# ---------------------------------------------------------------------------
# Row geometry: the broadcast by strides
# ---------------------------------------------------------------------------

RQ = 16                                        # r = n = 16: the 2^14 -R path


@pytest.mark.parametrize("case", ["a17 * cphi", "a16 * cc", "fold cc",
                                  "config 2"])
def test_main_path_shapes_read_in_place(case):
    """The three ring-product shapes of the -R path (FoldedState.
    phi_alpha_modq and fold) and config 2 (10^5 products): both operands
    read where they are, no copy, by the expected strides."""
    z = torch.zeros
    a, b, want = {
        "a17 * cphi": (z(D), z(RQ, D), (RQ, 0, 0, 0, D)),
        "a16 * cc": (z(D), z(RQ, RQ, D), (RQ * RQ, 0, 0, 0, D)),
        "fold cc": (z(RQ, D)[:, None], z(RQ, D)[None, :],
                    (RQ, D, 0, 0, D)),
        "config 2": (z(100_000, D), z(100_000, D), (100_000, 0, D, 0, D)),
    }[case]
    a, b = a.to(torch.int64), b.to(torch.int64)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    a2, b2, geom = polymul_cuda.coef_operands(a, b, shape)
    assert a2 is a and b2 is b
    assert geom == want


def test_row_geometry_merges_and_refuses():
    g = polymul_cuda.row_geometry
    assert g((), [], []) == (1, 0, 0, 0, 0)
    assert g((1, 1), [0, 0], [64, 64]) == (1, 0, 0, 0, 0)
    # (4, 4) contiguous rows against one fixed row: one axis
    assert g((4, 4), [256, 64], [0, 0]) == (16, 0, 64, 0, 0)
    # three axes that do not merge
    assert g((4, 4, 4), [256, 0, 64], [0, 64, 0]) is None
    # the outer broadcast
    assert g((16, 16), [64, 0], [0, 64]) == (16, 64, 0, 0, 64)


def test_wrapper_copies_what_it_cannot_read():
    """A transposed operand, one 8 bytes off the 16-byte alignment and a
    broadcast over three axes are copied; a last axis that broadcasts is
    widened to d."""
    rng = np.random.default_rng(3)
    for kind in ("transposed", "misaligned", "three_axes"):
        a, b = coef_inputs(8191, kind, rng)
        shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
        a2, _, geom = polymul_cuda.coef_operands(a, b, shape)
        assert a2 is not a and a2.is_contiguous()
        assert a2.data_ptr() % 16 == 0 and geom is not None
    col = _t(rng.integers(0, 8191, (5, 1)))
    a2, _, _ = polymul_cuda.coef_operands(col, _t(np.zeros((5, D))), (5, D))
    assert a2.shape == (5, D) and torch.equal(a2, col.expand(5, D))


def test_launch_takes_cuda_int64_only():
    plan = ntt.make_plan(8191)
    x = torch.zeros((2, D), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        polymul_cuda._launch_coef(x, x, plan)


# ---------------------------------------------------------------------------
# Index maps of the kernel
# ---------------------------------------------------------------------------

def test_window_covers_ext():
    """coef_product: at step i = 8 j + s the thread t's register buf[8 - s
    + r] holds ext[8 t + r - i + 64] (groups t + 7 - j and t + 8 - j, each
    within ext's 16 groups of 8)."""
    for t in range(8):
        for j in range(8):
            for s in range(8):
                for r in range(8):
                    p = 8 - s + r
                    group, elem = (t + 8 - j, p - 8) if p >= 8 else (
                        t + 7 - j, p)
                    assert 0 <= group < 16
                    assert 8 * group + elem == 8 * t + r - (8 * j + s) + D


def test_conversion_and_store_maps():
    """coef_convert's pairs c = tid + 256 s cover the tile's (row, column
    pair) once; the warp-staged store r of lane l reads what thread (warp,
    lane') computed for product 4 warp + r, outputs 2 l and 2 l + 1."""
    pairs = {((c := tid + COEF_THREADS * s) >> 5, 2 * (c & 31))
             for tid in range(COEF_THREADS)
             for s in range(COEF_TILE * D // 2 // COEF_THREADS)}
    assert pairs == {(rr, e) for rr in range(COEF_TILE)
                     for e in range(0, D, 2)}
    for warp in range(COEF_THREADS // 32):
        staged = {}
        for lane in range(32):                 # thread (pr, t) of this warp
            tid = 32 * warp + lane
            pr, t = tid >> 3, tid & 7
            for e in range(8):
                staged[8 * lane + e] = (pr, 8 * t + e)
        for r in range(4):
            for lane in range(32):
                for e in range(2):
                    assert staged[64 * r + 2 * lane + e] == (
                        4 * warp + r, 2 * lane + e)

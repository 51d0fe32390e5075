"""The port on a CUDA card: every kernel held bit-equal to its plain
PyTorch version, the config-1 flows against the JAX package's golden
files, and the 2^14 flows.

* ``ROWS``, the case table: one row for each kernel, mode, modulus and
  shape, with the kernel call, its plain call, the ``KernelInfo`` its
  launches count in, the inputs from a fixed seed and the ``Work`` of a
  call.  ``test_kernel_matches_plain[row]`` requires the kernel bit-equal
  to the plain version (and to the row's other yardsticks: a library
  call, hashlib, single launches) and its launches exactly the row's
  count.  ``chip_smoke.py`` times the same rows against ``Work.bound``;
  the first row of each ``KernelInfo`` in table order is its line in the
  kernel table.
* ``golden_flow(name)``: the CLI's config-1 flows against
  ``labrador_tpu_torch/golden/``, each launching the kernels of its
  modulus and none of the other's.
* ``FLOWS_2P14``: the 2^14 flows (n = r = 16, kappa = 256,
  BASELINE.json config 3) at both moduli, checkpointed proving, the
  ChaCha CRS, batches of proves and the JL projection above 2^22
  coefficients.

``test_golden_flow`` and ``test_flow_2p14`` run the flows; ``chip_smoke.py``
runs them too, counting each one's launches.  Only the table's coverage
runs on the CPU.  The rest is marked ``cuda`` and skips without a card.
This file imports nothing of JAX, so on a card machine:
    python -m pytest tests/test_torch_cuda.py tests/test_torch_sharded.py \
        -m cuda --noconftest -q
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Callable

import numpy as np
import pytest
import torch

from labrador_tpu_torch import (keys, prover, recursion, sampling, structs,
                                verifier)
from labrador_tpu_torch.cli import make_instance, make_params, run_flow
from labrador_tpu_torch.crs import (CRS, CRSBatch, MaterializedCRS,
                                    _used_intervals)
from labrador_tpu_torch.ops import (ajtai_cuda, alpha_cuda, cd_cuda,
                                    cuda_lib, ntt, polymul_cuda, sha256,
                                    sha_cuda, sha_prng, u1_cuda)
from labrador_tpu_torch.ops.ring_stream import circulant
from labrador_tpu_torch.ops.zq import is_big, to_signed_small
from labrador_tpu_torch.params import LabradorParams
from labrador_tpu_torch.protocol import (AxisCtx, _kappa_shard,
                                         _stream_shard, _tri_stream)
from labrador_tpu_torch.utils import refsim
from port_golden import chacha_proofs, chacha_record, port_fs_flow
from test_torch_coef_kernel import KINDS, coef_inputs

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden"
KERNEL_MODULES = (polymul_cuda, sha_cuda, alpha_cuda, ajtai_cuda, u1_cuda,
                  cd_cuda)
COMMIT_MODULES = (ajtai_cuda, u1_cuda, cd_cuda)
MODULI = {"small": {}, "big": dict(q_start=(1 << 32) - 1, exact_digits=True),
          # the largest prime below 2^33, the top of the big-q range: the
          # kernels' products of two centred values reach 2^64 there
          "top": dict(q_start=(1 << 33) - 9, exact_digits=True)}
REAL = dict(n=16, r=16, kappa=256)       # BASELINE.json config 3
SHAPES = {"2p14": dict(n=16, r=16, kappa_override=256),
          "config1": dict(n=2, r=2),
          # a u2 stream (L = 84) off the Pallas step, t_2 = 2 < t_1 = 4
          "r6k16": dict(n=2, r=6, kappa_override=16),
          "k16": dict(n=2, r=2, kappa_override=16)}
CHACHA_SEED = bytes(range(32))

# ---------------------------------------------------------------------------
# the Work of a call, and the least time the card could take for it
# ---------------------------------------------------------------------------

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3 at
# 3.35 TB/s; int8 tensor-core operations at 1,979 T/s; int32 operations
# outside the tensor cores at 132 SMs x 64 INT32 lanes x the 1.98 GHz boost
# clock, one IMAD per lane per clock.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one Threefry-2x32 block (20 rounds of add, rotate,
# xor; 5 key injections of 3 adds), the least work per CRS entry; of one
# SHA-256 stream block (csrc/sha_stream.cu) with three-input logic and adds
# and one-instruction rotations: 64 rounds of 14, 48 schedule steps of 10,
# the 8 adds of H0, less the 53 that fold where a message or state word is
# a constant; of one big-q multiply-add on the CUDA cores (a 64-bit
# product, two wide IMADs, and its 128-bit accumulation, two adds with
# carry).
THREEFRY_OPS = 20 * 3 + 5 * 3
SHA_OPS = 64 * 14 + 48 * 10 + 8 - 53
BIG_MAC_OPS = 4


@dataclasses.dataclass
class Work:
    """What one call must do: bytes (each input read once, each output
    written once), int32 operations that only the CUDA cores can do
    (Threefry, SHA-256), and multiply-adds of small integers, each of which
    int8 tensor cores can do as limb_products limb products of two
    operations (mac_ops int32 operations each on the CUDA cores)."""

    nbytes: float
    int32_ops: float
    macs: float
    limb_products: int
    mac_ops: int = 1

    def times(self, B: int) -> Work:
        return dataclasses.replace(self, nbytes=self.nbytes * B,
                                   int32_ops=self.int32_ops * B,
                                   macs=self.macs * B)

    def bound(self) -> tuple[float, str]:
        """The least time (ms) the card could take: the larger of the bytes
        over the memory rate and the operations over their peak rates
        (Threefry on the CUDA cores, multiply-adds on int8 tensor cores)."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(self.int32_ops / INT32_OPS_PER_S,
                    2 * self.macs * self.limb_products
                    / INT8_TC_OPS_PER_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def cuda_core_ms(self) -> float:
        """The same bound with the multiply-adds on the CUDA cores, printed
        beside the bound: the commitment kernels take them on int8 tensor
        cores."""
        return max(self.nbytes / HBM_BYTES_PER_S,
                   (self.int32_ops + self.macs * self.mac_ops)
                   / INT32_OPS_PER_S) * 1e3

    def describe(self) -> str:
        bound_ms, bound_by = self.bound()
        return (f"bound {bound_ms:.4f} ms ({bound_by}, {self.limb_products} "
                f"limb products; CUDA-core bound "
                f"{self.cuda_core_ms():.4f} ms)")


@dataclasses.dataclass
class Row:
    """One case of the table: ``make(device)`` builds its inputs and
    returns a ``Case``; a kernel call launches ``info`` ``launches``
    times."""

    id: str
    info: cuda_lib.KernelInfo
    make: Callable[[str], Case]
    launches: int = 1


@dataclasses.dataclass
class Case:
    """The kernel call, its plain version, the Work of one call, and
    further calls whose result must equal the kernel's (``library``: one
    library call computing the same function)."""

    kernel: Callable
    plain: Callable
    cost: Work
    also: dict = dataclasses.field(default_factory=dict)


def kernel_infos() -> list:
    """Every ``KernelInfo`` of the six kernel wrapper modules."""
    return [v for m in KERNEL_MODULES for v in vars(m).values()
            if isinstance(v, cuda_lib.KernelInfo)]


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def _limbs(max_abs: int) -> int:
    """8-bit limbs an int8 tensor-core product needs for |x| <= max_abs."""
    return 1 if max_abs <= 127 else -(-max_abs.bit_length() // 8)


def _params(shape: str, q: str) -> LabradorParams:
    if shape == "folded":
        # the 2^14 -R instance's folded shape (the CLI's layout, beta' at
        # its bound): r' = 180, n' = 175 at q = 8191; 135 / 132 at big q
        p = make_params(16, 16, 256, True, q == "big")
        return recursion.folded_params(recursion.make_layout(p), 16,
                                       recursion.beta_new_max(p))
    return LabradorParams(**SHAPES[shape], **MODULI[q])


def _cost(p, rows: int, L: int, nrhs: int, max_rhs: int,
          lp: int | None = None) -> Work:
    """One stream contraction of rows x L ring elements against nrhs
    right-hand sides below max_rhs in size: the operands in and the result
    out; a Threefry block per entry; d multiply-adds per entry and
    right-hand side, each ``lp`` limb products (by default the entry's
    limbs, a residue below q or centred at big q, times the operand's)."""
    big = is_big(p.q)
    entries = rows * L * p.d
    if lp is None:
        lp = _limbs(p.q // 2 if big else p.q - 1) * _limbs(max_rhs)
    return Work(nbytes=8 * p.d * nrhs * (L + rows),
                int32_ops=entries * THREEFRY_OPS,
                macs=entries * p.d * nrhs, limb_products=lp,
                mac_ops=BIG_MAC_OPS if big else 1)


# ---------------------------------------------------------------------------
# kernels 2-4 (Ajtai, the u1 B-term, the C/D sums) in every mode
# ---------------------------------------------------------------------------

def _operands(p, seed: int, device) -> SimpleNamespace:
    """Kernels 2-4's operands at the shapes of ``p`` from a numpy seed.
    Small q: random residues for Ajtai, random centred digits lifted mod q.
    Big q, the JAX package's convention: signed operands at their bounds,
    an Ajtai witness up to q/2 (the most the kernel takes) with -2^31 in
    it (check 15's int32 wrap of an oversized z), digits up to +-b/2."""
    rng = np.random.default_rng(seed)
    big = is_big(p.q)

    def signed(top: int, shape):
        x = rng.integers(-top, top + 1, shape)
        x.reshape(-1)[:2] = [top, -top]
        return x

    def digits(base: int, shape):
        x = signed(base // 2, shape)
        return _t(x if big else x % p.q, device)

    if big:
        w = signed(p.q // 2, (p.r, p.n, p.d))
        w.reshape(-1)[2] = -(1 << 31)
    else:
        w = rng.integers(0, p.q, (p.r, p.n, p.d))
    return SimpleNamespace(
        w=_t(w, device), w_max=p.q // 2 if big else p.q - 1,
        t_dig=digits(p.b_1, (p.t_1, p.r, p.kappa, p.d)),
        g_str=_tri_stream(digits(p.b_2, (p.t_2, p.r, p.r, p.d)), p),
        h_str=_tri_stream(digits(p.b_1, (p.t_1, p.r, p.r, p.d)), p))


def _commit(call: str, p, crs, x, cut=None):
    """(kernel fn, plain fn, fn of the library call's digits (nrhs, L,
    d), Work counts) of one kernel 2-4 call on ``crs`` (a CRS, a CRSBatch
    with operands leading with B, or a MaterializedCRS), whole or shard
    ``cut`` = (i, n) as ``protocol.AxisCtx`` cuts it."""
    ctx = None if cut is None else AxisCtx(None, cut[1], cut[0])
    if call.startswith("ajtai"):
        w = x.w if call == "ajtai" else x.w[..., :1, :, :]
        rng_ = () if ctx is None else _kappa_shard(p.kappa, ctx)
        rows = rng_[1] if rng_ else p.kappa
        lp = ajtai_cuda.entry_limbs(p.q) * ajtai_cuda.witness_limbs(p.q)
        return (lambda: ajtai_cuda.ajtai_commit(crs, w, *rng_),
                lambda: ajtai_cuda.ajtai_commit_plain(crs, w, *rng_),
                lambda: w,
                _cost(p, rows, p.n, w.shape[-3], x.w_max, lp))
    if call == "u1":
        rng_ = () if ctx is None else _kappa_shard(p.kappa, ctx)
        cols = rng_[1] if rng_ else p.kappa
        return (lambda: u1_cuda.u1_bterm(crs, x.t_dig, *rng_),
                lambda: u1_cuda.u1_bterm_plain(crs, x.t_dig, *rng_),
                lambda: u1_cuda._stream(x.t_dig, p, *rng_),
                _cost(p, p.kappa_1, p.r * p.t_1 * cols, 1, p.b_1 // 2))
    stream, off, t_used, base = ((x.h_str, crs._off_d, p.t_1, 0)
                                 if call == "cdD" else
                                 (x.g_str, crs._off_c, p.t_2, p.b_2))
    total = stream.shape[-3] * t_used
    rng_ = () if ctx is None else _stream_shard(total, ctx)
    return (lambda: cd_cuda.cd_sum(crs, stream, off, t_used, base, *rng_),
            lambda: cd_cuda.cd_sum_plain(crs, stream, off, t_used, *rng_),
            lambda: cd_cuda._local_digits(stream, *(rng_ or (0, None)))[
                None],
            _cost(p, p.kappa_2, rng_[1] if rng_ else total, 1,
                  (base or p.b_1) // 2))


def _module(call: str):
    return {"a": ajtai_cuda, "u": u1_cuda, "c": cd_cuda}[call[0]]


def _info(call: str, q, ranged: bool = False, batched: bool = False):
    """The KernelInfo a Threefry launch of kernel 2-4 ``call`` counts in,
    at modulus q (a size name of MODULI, or q itself)."""
    q = {"small": 8191, "big": 4294967311, "top": 8589934583}.get(q, q)
    return cuda_lib.launch_info(_module(call), q, ranged, batched)


def _compose(call: str, parts: list, q: int) -> torch.Tensor:
    """Shards' results as the whole: Ajtai's rows concatenated, u1's and
    C/D's partial sums added mod q."""
    if call.startswith("ajtai"):
        return torch.cat(parts, -2)
    return sum(parts) % q


def _threefry_row(shape: str, q: str, call: str, cut=None,
                  composed: bool = False) -> Row:
    """Kernel 2-4 ``call`` on a Threefry CRS (seed 7): whole, shard ``cut``
    of a range mode, or every shard of ``cut[1]`` composed against the
    unranged plain version (a C/D shard past the stream's end is empty
    and launches nothing)."""
    ranged = cut is not None
    launches = cut[1] if composed else 1
    if composed and call.startswith("cd"):
        p = _params(shape, q)
        total = p.r * (p.r + 1) // 2 * (p.t_1 if call == "cdD" else p.t_2)
        launches = sum(1 for i in range(cut[1])
                       if _stream_shard(total, AxisCtx(None, cut[1], i))[1])

    def make(device):
        p = _params(shape, q)
        crs = CRS.create(p, seed=0xC0FFEE + 7)
        x = _operands(p, 7, device)
        if not composed:
            kern, plain, _, cost = _commit(call, p, crs, x, cut)
            return Case(kern, plain, cost)
        n = cut[1]
        shards = [_commit(call, p, crs, x, (i, n)) for i in range(n)]
        whole = _commit(call, p, crs, x)
        return Case(lambda: _compose(call, [s[0]() for s in shards], p.q),
                    whole[1], shards[0][3].times(n))

    tag = ("" if not ranged else
           f"-shards{cut[1]}" if composed else f"-shard{cut[0]}of{cut[1]}")
    return Row(f"{'range' if ranged else 'threefry'}-{shape}-{q}-{call}{tag}",
               _info(call, q, ranged), make, launches)


def _residue_witness_row(shape: str, q: str) -> Row:
    """Big-q Ajtai on the witness's residues mod q against the plain
    version of the signed witness."""
    def make(device):
        p = _params(shape, q)
        crs = CRS.create(p, seed=0xC0FFEE + 7)
        x = _operands(p, 7, device)
        _, plain, _, cost = _commit("ajtai", p, crs, x)
        return Case(lambda: ajtai_cuda.ajtai_commit(crs, x.w % p.q), plain,
                    cost)
    return Row(f"threefry-{shape}-{q}-ajtai_residues", _info("ajtai", q),
               make)


def _drawn(plain, crs):
    """plain() on a copy of the MaterializedCRS that records the offsets
    its plain version reads: (result, offsets (rows, L, d))."""
    drawn = []

    class Recording(MaterializedCRS):
        def draw(self, offsets):
            drawn.append(offsets)
            return super().draw(offsets)

    out = plain(Recording(coeffs=crs.coeffs, key=crs.key, params=crs.params))
    return out, torch.cat(drawn, 1)


def _library_call(table, offs, dig, q: int, shape):
    """The table mode's function as one gather and one float64 product:
    the tile by ``torch.take`` at the offsets, contracted with one
    ``torch.matmul`` against the centred digits' negacyclic circulant
    (every partial sum an integer below 2^53, so exact), then mod q.  The
    offsets and the circulant are made once, outside the call."""
    rows, L, d = offs.shape
    idx = offs.reshape(rows, L * d)
    circ = circulant(to_signed_small(dig, q)).reshape(
        dig.shape[0], L * d, d).to(torch.float64)

    def call():
        tile = torch.take(table, idx).to(torch.float64)
        return torch.remainder(torch.matmul(tile, circ),
                               q).to(torch.int64).reshape(shape)
    return call


def _table_row(shape: str, call: str, cut=None) -> Row:
    """A table mode on a MaterializedCRS: config 1 on its ChaCha table,
    2^14 on random residues of the layout's size (exactness does not
    depend on ChaCha values); the bytes bound counts each distinct table
    entry read, and the library call is timed beside."""
    def make(device):
        p = _params(shape, "small")
        if shape == "config1":
            crs = MaterializedCRS.create_chacha(p, bytes(range(32)), device)
        else:
            gen = torch.Generator(device).manual_seed(11)
            crs = MaterializedCRS(
                coeffs=torch.randint(0, p.q, (_used_intervals(p)[-1][1],),
                                     dtype=torch.int32, device=device,
                                     generator=gen),
                key=(1, 2), params=p)
        x = _operands(p, 7, device)
        kern, plain, dig, cost = _commit(call, p, crs, x, cut)
        want, offs = _drawn(lambda c: _commit(call, p, c, x, cut)[1](), crs)
        seen = torch.zeros(crs.coeffs.numel(), dtype=torch.bool,
                           device=device)
        seen[offs.reshape(-1)] = True
        cost = dataclasses.replace(cost, int32_ops=0, nbytes=cost.nbytes
                                   + 4 * int(seen.sum()))
        return Case(kern, plain, cost, {"library": _library_call(
            crs.coeffs, offs, dig(), p.q, want.shape)})

    tag = "" if cut is None else f"-shard{cut[0]}of{cut[1]}"
    return Row(f"table-{shape}-{call}{tag}", _module(call).KERNEL_TABLE,
               make)


def _batch_row(shape: str, B: int, q: str, call: str, cut=None) -> Row:
    """A batch mode: B instances (seeds 11 .. 11 + B - 1, each its own
    CRS) in one launch, whole or every instance in shard ``cut`` (a
    ranged launch counts in the range mode's info), against the batch
    plain version and B single launches."""

    def make(device):
        p = _params(shape, q)
        crss = [CRS.create(p, seed=0xC0FFEE + 11 + b) for b in range(B)]
        xs = [_operands(p, 11 + b, device) for b in range(B)]
        x = SimpleNamespace(w_max=xs[0].w_max, **{
            k: torch.stack([getattr(y, k) for y in xs])
            for k in ("w", "t_dig", "g_str", "h_str")})
        crs = CRSBatch.stack(crss, device=device)
        kern, plain, _, cost = _commit(call, p, crs, x, cut)
        singles = [_commit(call, p, c, y, cut)[0] for c, y in zip(crss, xs)]
        return Case(kern, plain, cost.times(B), {
            "singles": lambda: torch.stack([s() for s in singles])})

    tag = "" if cut is None else f"-shard{cut[0]}of{cut[1]}"
    return Row(f"batch-{shape}-B{B}-{q}-{call}{tag}",
               _info(call, q, cut is not None, True), make)


# (q, base) of the digit-limb rows, and the limbs each base takes: 1-2
# at small q, 1-4 at big q
DIGIT_MODES = [(8191, 9), (8191, 8191), (4294967311, 2), (4294967311, 1625),
               (4294967311, 65536), (8589934583, 1 << 24)]
DIGIT_LIMBS = {2: 1, 9: 1, 1625: 2, 8191: 2, 65536: 3, 1 << 24: 4}


def _digit_mode_row(call: str, q: int, base: int) -> Row:
    """Each digit-limb mode of the u1 / C/D kernel (1-2 limbs at small q,
    1-4 at big q) at the folded kappa_1 = kappa_2 = 16 shape, where a
    block's warps split the stream, digits at the largest magnitude the
    limbs hold."""
    def make(device):
        p = LabradorParams(n=13, r=15, q=q, k_count=51, l_count=1,
                           kappa_override=16, exact_digits=True)
        if call == "u1":
            object.__setattr__(p, "b_1", base)     # the digit-limb mode
        top = min(base // 2, u1_cuda.limb_cover(u1_cuda.digit_limbs(base)))
        rng = np.random.default_rng(base)
        crs = CRS.create(p, 0xC0DE)

        def digits(shape):
            x = rng.choice([-top, top, 0, 1], shape)
            return _t(x if is_big(q) else x % q, device)

        if call == "u1":
            t_dig = digits((p.t_1, p.r, p.kappa, p.d))
            return Case(lambda: u1_cuda.u1_bterm(crs, t_dig),
                        lambda: u1_cuda.u1_bterm_plain(crs, t_dig),
                        _cost(p, p.kappa_1, p.r * p.t_1 * p.kappa, 1, top))
        off, t_used = ((crs._off_c, p.t_2) if call == "cdC"
                       else (crs._off_d, p.t_1))
        stream = _tri_stream(digits((t_used, p.r, p.r, p.d)), p)
        return Case(lambda: cd_cuda.cd_sum(crs, stream, off, t_used, base),
                    lambda: cd_cuda.cd_sum_plain(crs, stream, off, t_used),
                    _cost(p, p.kappa_2, stream.shape[0] * t_used, 1, top))

    return Row(f"digits-{call}-q{q}-b{base}", _info(call, q), make)


def _ajtai_edge_row(q: str, r_eff: int) -> Row:
    """The tensor-core Ajtai kernel at r_eff in {1, 3, 16} (one vector, a
    group not filled, several groups), kappa = 24 (3 row tiles) and n = 37
    ring elements (a partial chunk); at big q a witness at +-q/2 and in
    the band above what four signed limbs hold, and residues up to q - 1."""
    def make(device):
        p = LabradorParams(n=37, r=16, kappa_override=24, **MODULI[q])
        crs = CRS.create(p, 0xC0DE + r_eff)
        rng = np.random.default_rng(r_eff)
        shape = (r_eff, p.n, p.d)
        if q == "small":
            w = rng.integers(0, p.q, shape)
            w.reshape(-1)[:4] = [0, p.q - 1, p.q // 2, p.q // 2 + 1]
        else:
            h, four = p.q // 2, 127 * (256**4 - 1) // 255
            w = rng.integers(-h, h + 1, shape)
            band = rng.integers(four + 1, h + 1, w.size // 4)
            w.reshape(-1)[: band.size] = band * rng.choice([-1, 1],
                                                           band.size)
            w.reshape(-1)[-5:] = [h, -h, four + 1, -four - 1, p.q - 1]
        w = _t(w, device)
        lp = ajtai_cuda.entry_limbs(p.q) * ajtai_cuda.witness_limbs(p.q)
        return Case(lambda: ajtai_cuda.ajtai_commit(crs, w),
                    lambda: ajtai_cuda.ajtai_commit_plain(crs, w),
                    _cost(p, p.kappa, p.n, r_eff, p.q // 2, lp))
    return Row(f"ajtai_edges-{q}-r{r_eff}", _info("ajtai", q), make)


# ---------------------------------------------------------------------------
# kernel 1 (the negacyclic polymul: coefficient and bhat variants)
# ---------------------------------------------------------------------------

POLY_PRODUCTS = 100_000                  # BASELINE.json config 2
POLY_TAIL = 99_999                       # not a multiple of 32 (COEF_TILE)
POLY_SERVING = 65_536                    # bench.py's fixed-operand batch
POLY_SERVING_TAIL = 65_531               # not a multiple of 8 (BHAT_ROWS)
POLY_ROWS = 1024 + 77                    # ntt_pallas.BLOCK + 77


def _polymul_row(label: str) -> Row:
    """Kernel 1 at config 1's q = 8191 (3 CRT primes): config 2 (10^5
    products, its float64 grouped conv1d as the library call) and 99,999
    products (a partial final block); the fixed-operand serving shape
    (65,536 rows against bhat (P, 1, 64), a float64 matmul by b's
    negacyclic matrix as the library call), the same over 65,531 rows (a
    partial final tile) and random canonical per-prime residues (Garner
    beyond the forward transform's image); the ring products of the 2^14
    -R path; a padded Pallas grid (1,101 rows) each way and one operand
    broadcast."""
    def make(device):
        p = LabradorParams(n=2, r=2)
        plan = ntt.plan_for(p)
        P, q, d = plan.n_primes, p.q, p.d
        rng = np.random.default_rng(2)
        a = _t(rng.integers(0, q, (POLY_PRODUCTS, d)), device)
        b = _t(rng.integers(0, q, (POLY_PRODUCTS, d)), device)
        pv = np.asarray(plan.primes).reshape(P, 1, 1)
        bhat_fixed = ntt.ntt_fwd(b[:1], plan)                 # (P, 1, d)
        lp_q, lp_p = _limbs(q - 1) ** 2, _limbs(max(plan.primes) - 1) ** 2

        def rows(x):
            return x.numel() // x.shape[-1]

        def coef(x, y, also=None):
            n_out = torch.Size(torch.broadcast_shapes(x.shape,
                                                      y.shape)).numel() // d
            return Case(lambda: polymul_cuda.negacyclic_polymul(x, y, plan),
                        lambda: polymul_cuda.negacyclic_polymul_plain(
                            x, y, plan),
                        Work(nbytes=8 * d * (rows(x) + rows(y) + n_out),
                             int32_ops=0, macs=n_out * d * d,
                             limb_products=lp_q, mac_ops=1), also or {})

        def bhat(x, bh, also=None):
            n = rows(x)
            return Case(lambda: polymul_cuda.negacyclic_polymul_bhat(
                            x, bh, plan),
                        lambda: polymul_cuda.negacyclic_polymul_bhat_plain(
                            x, bh, plan),
                        Work(nbytes=8 * d * (2 * n + rows(bh)), int32_ops=0,
                             macs=n * P * 2 * d * d, limb_products=lp_p,
                             mac_ops=1), also or {})

        if label == "config2":
            xf = torch.cat([-b, b], 1).to(torch.float64).reshape(
                1, POLY_PRODUCTS, 2 * d)
            wf = torch.flip(a, (1,)).to(torch.float64).reshape(
                POLY_PRODUCTS, 1, d)
            return coef(a, b, {"library": lambda: torch.remainder(
                torch.nn.functional.conv1d(xf, wf, groups=POLY_PRODUCTS)[
                    0, :, 1:d + 1].to(torch.int64), q)})
        if label == "config2_tail":
            return coef(a[:POLY_TAIL].contiguous(),
                        b[:POLY_TAIL].contiguous())
        if label == "serving":
            a_s = a[:POLY_SERVING].contiguous()
            nb = circulant(ntt.ntt_inv_modq(bhat_fixed, plan)[0]).to(
                torch.float64)
            a_f = a_s.to(torch.float64)
            return bhat(a_s, bhat_fixed, {"library": lambda: torch.remainder(
                torch.matmul(a_f, nb).to(torch.int64), q)})
        a_st = a[:POLY_SERVING_TAIL].contiguous()
        bhat_rand = _t(rng.integers(0, 1 << 62, (P, POLY_SERVING_TAIL, d))
                       % pv, device)
        n0, pr = REAL["n"], a[:POLY_ROWS].contiguous()
        return {
            "serving_tail": lambda: bhat(a_st, bhat_fixed),
            "bhat_random": lambda: bhat(a_st, bhat_rand),
            "R_a17_cphi": lambda: coef(a[0], b[:n0]),
            "R_a16_cc": lambda: coef(a[0], b[:n0 * n0].reshape(n0, n0, d)),
            "R_fold_cc": lambda: coef(a[:n0, None], b[None, :n0]),
            "grid": lambda: coef(pr, b[:POLY_ROWS].contiguous()),
            "broadcast": lambda: coef(a[0], b[:5]),
            "grid_bhat_fixed": lambda: bhat(pr, bhat_fixed),
            "grid_bhat_random": lambda: bhat(pr, bhat_rand[:, :POLY_ROWS]
                                             .contiguous()),
        }[label]()
    return Row(f"polymul-{label}", polymul_cuda.KERNEL, make)


def _coef_edge_row(q: int, kind: str) -> Row:
    """The coefficient kernel on ``tests/test_torch_coef_kernel.py``'s
    input kinds at q = 8191 (no flush) and 32513 (a flush every 8 terms),
    against the plain version of the operands' residues mod q (the plain
    version takes |x| < q, beyond which its CRT transforms wrap)."""
    def make(device):
        plan = ntt.make_plan(q)
        a, b = coef_inputs(q, kind, np.random.default_rng(q + len(kind)),
                           device)
        n_out = torch.Size(torch.broadcast_shapes(a.shape, b.shape)).numel() \
            // plan.d
        return Case(lambda: polymul_cuda.negacyclic_polymul(a, b, plan),
                    lambda: polymul_cuda.negacyclic_polymul_plain(
                        torch.remainder(a, q), torch.remainder(b, q), plan),
                    Work(nbytes=8 * plan.d * 3 * n_out, int32_ops=0,
                         macs=n_out * plan.d ** 2,
                         limb_products=_limbs(q - 1) ** 2, mac_ops=1))
    return Row(f"polymul_edges-q{q}-{kind}", polymul_cuda.KERNEL, make)


def _bhat_edge_row(q: int, kind: str, n: int) -> Row:
    """The tensor-core bhat kernel: a fixed and a per-row operand, 0 and
    p - 1 in a and in bhat, signed and out-of-range int64 a; 1,001 rows (a
    partial last tile) and one row; at q = 8191 (3 CRT primes) and 32513
    (4)."""
    def make(device):
        plan = ntt.plan_for(LabradorParams(n=2, r=2)) if q == 8191 \
            else ntt.make_plan(q)
        P, d = plan.n_primes, plan.d
        pv = np.asarray(plan.primes).reshape(P, 1, 1)
        rng = np.random.default_rng(q + len(kind) + n)
        a = rng.integers(0, q, (n, d))
        rows = 1 if kind.startswith("fixed") else n
        bh = rng.integers(0, 1 << 62, (P, rows, d)) % pv
        if kind.endswith("edges"):
            a[: (n + 1) // 2] = rng.choice([0, q - 1], ((n + 1) // 2, d))
            bh = rng.choice([0, 1], (P, rows, d)) * (pv - 1)
        if kind == "signed":
            a = rng.integers(-(1 << 62), 1 << 62, (n, d))
            a[0, :4] = [-(1 << 63), (1 << 63) - 1, -q + 1, -1]
        ca, cb = _t(a, device), _t(bh, device)
        return Case(lambda: polymul_cuda.negacyclic_polymul_bhat(ca, cb,
                                                                 plan),
                    lambda: polymul_cuda.negacyclic_polymul_bhat_plain(
                        ca, cb, plan),
                    Work(nbytes=8 * d * (2 * n + rows), int32_ops=0,
                         macs=n * P * 2 * d * d,
                         limb_products=_limbs(max(plan.primes) - 1) ** 2,
                         mac_ops=1))
    return Row(f"bhat_edges-q{q}-{kind}-n{n}", polymul_cuda.KERNEL, make)


# ---------------------------------------------------------------------------
# the SHA-256 stream kernel and the alpha-contraction kernel
# ---------------------------------------------------------------------------

SHA_KEYS = [hashlib.sha256(b"stream key %d" % i).digest() for i in range(16)]


def _sha_row(n_keys: int, n_words: int, label: str = "") -> Row:
    """The stream kernel (``sha_cuda.sha_stream``, as
    ``sha_prng.stream_device`` calls it on the card) against its plain
    version (``stream_plain``, SHA-256 in torch ops) and hashlib: at the
    2^14 JL shape (16 keys x 256 x 1,024 words, 524,288 blocks), at a
    partial final block, and at word counts across the block
    boundaries."""
    def make(device):
        ks = SHA_KEYS[:n_keys]
        nb = -(-n_words // 8)
        blocks = n_keys * nb
        kw = torch.tensor([sha256.digest_words(k) for k in ks],
                          dtype=torch.int64, device=device)
        return Case(lambda: sha_cuda.sha_stream(kw, nb, sha_prng.DOM_BITS)[
                        :, :n_words],
                    lambda: sha_prng.stream_plain(ks, n_words, device),
                    Work(nbytes=blocks * 64 + n_keys * 64,
                         int32_ops=blocks * SHA_OPS, macs=0, limb_products=1,
                         mac_ops=1),
                    {"library": lambda: _t(sha_prng.stream_host(
                        ks, n_words).astype(np.int64), device)})
    return Row(f"sha-{label or f'{n_keys}keys-{n_words}words'}",
               sha_cuda.KERNEL, make)


def _sample_jl_row() -> Row:
    """sample_jl_matrices of 16 ShaKeys at 2^14 on the card (one stream
    launch) against the CPU route's."""
    def make(device):
        p = LabradorParams(n=16, r=16)
        ks = [keys.ShaKey(k) for k in SHA_KEYS]
        blocks = 16 * 256 * p.n * p.d // 8
        return Case(lambda: sampling.sample_jl_matrices(ks, p, device),
                    lambda: sampling.sample_jl_matrices(ks, p, "cpu").to(
                        device),
                    Work(nbytes=blocks * 64, int32_ops=blocks * SHA_OPS,
                         macs=0, limb_products=1, mac_ops=1))
    return Row("sha-sample_jl-2p14", sha_cuda.KERNEL, make)


def _alpha_weights(q: int, L: int, seed: int, device) -> torch.Tensor:
    """(L, d) residues, the edges 0, 1, +-(q - 1)/2, q - 1 first."""
    x = np.random.default_rng(seed).integers(0, q, (L, 64))
    x.reshape(-1)[:5] = [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]
    return _t(x, device)


def _alpha_pass(p, crs, which: str, w=None):
    """(L, rows, kernel args) of one pass of ``phi_alpha_modq``
    (``ops/alpha_cuda``: A, B, and C and D apart), the weights ``w``
    (L, d) where given, and its Work counts: the weights take as many
    limbs as the entries, both centred at big q."""
    n_tri = p.r * (p.r + 1) // 2
    L, rows, head, tail = {
        "A": (p.kappa, p.n, (), ()),
        "B": (p.kappa_1, p.r * p.t_1 * p.kappa, (), ()),
        "C": (p.kappa_2, n_tri * p.t_2, (crs._off_c,), (p.t_2,)),
        "D": (p.kappa_2, n_tri * p.t_1, (crs._off_d,), (p.t_1,))}[which]
    top = p.q // 2 if is_big(p.q) else p.q - 1
    return (L, (crs, *head, w, *tail),
            _cost(p, rows, L, 1, top, _limbs(top) ** 2))


def _alpha_row(q: str, which: str) -> Row:
    """One alpha-contraction pass at the fold cell's 2^14 base on random
    weights with the edge residues."""
    def make(device):
        p = _params("2p14", q)
        crs = CRS.create(p, 0xA1FA)
        L = _alpha_pass(p, crs, which)[0]
        _, args, cost = _alpha_pass(p, crs, which,
                                    _alpha_weights(p.q, L, 11, device))
        name = "alpha_" + ("cd" if which in "CD" else which.lower())
        kern, plain = (getattr(alpha_cuda, name + s) for s in ("", "_plain"))
        return Case(lambda: kern(*args), lambda: plain(*args), cost)
    return Row(f"alpha-2p14-{q}-{which}",
               alpha_cuda.KERNEL if q == "small" else alpha_cuda.KERNEL_BIG,
               make)


def _plain_alpha(fn):
    """fn() with every alpha-contraction on its plain version."""
    names = ("alpha_a", "alpha_b", "alpha_cd")
    saved = [getattr(alpha_cuda, n) for n in names]
    try:
        for n in names:
            setattr(alpha_cuda, n, getattr(alpha_cuda, n + "_plain"))
        return fn()
    finally:
        for n, f in zip(names, saved):
            setattr(alpha_cuda, n, f)


def _phi_alpha_row(shape: str, mu: int) -> Row:
    """``FoldedState.phi_alpha_modq`` on the kernel route (four launches:
    A, B, C, D) against the same call on the plain route, at the fold
    cell's 2^14 big-q base (mu = 16) and at config 1, q = 8191, on random
    transcript blocks and alpha with the edge residues."""
    big = shape == "2p14"

    def make(device):
        p = _params("2p14", "big") if big else LabradorParams(
            n=2, r=2, exact_digits=True)                     # cli -R's
        rng = np.random.default_rng(0xA1FA)

        def rand(*s):
            return _t(rng.integers(0, p.q, s), device)

        lay = recursion.make_layout(p, mu)
        st = recursion.FoldedState(
            base_crs=CRS.create(p, 0xA1FA), c=rand(p.r, p.d),
            cc=rand(p.r, p.r, p.d), cphi=rand(p.n, p.d),
            a_fin=rand(p.r, p.r, p.d),
            phi0=torch.zeros((1, lay.r_new, lay.n_new, p.d),
                             dtype=torch.int64, device=device),
            b_k=rand(lay.k_new, p.d), layout=lay)
        alpha = _alpha_weights(p.q, lay.k_new, 6, device)
        costs = [_alpha_pass(p, st.base_crs, x)[2] for x in "ABCD"]
        return Case(lambda: st.phi_alpha_modq(alpha),
                    lambda: _plain_alpha(lambda: st.phi_alpha_modq(alpha)),
                    dataclasses.replace(
                        costs[0], **{k: sum(getattr(c, k) for c in costs)
                                     for k in ("nbytes", "int32_ops",
                                               "macs")}))
    return Row(f"phi_alpha-{shape}-mu{mu}",
               alpha_cuda.KERNEL_BIG if big else alpha_cuda.KERNEL, make, 4)


# ---------------------------------------------------------------------------
# the table; the first row of each KernelInfo is its kernel-table line
# ---------------------------------------------------------------------------

ROWS = (
    [_polymul_row(x) for x in (
        "config2", "config2_tail", "serving", "serving_tail", "bhat_random",
        "R_a17_cphi", "R_a16_cc", "R_fold_cc", "grid", "broadcast",
        "grid_bhat_fixed", "grid_bhat_random")]
    + [_coef_edge_row(q, k) for q in (8191, 32513) for k in KINDS]
    + [_bhat_edge_row(q, k, n) for q in (8191, 32513)
       for k in ("fixed", "fixed_edges", "per_row", "edges", "signed")
       for n in (1001, 1)]
    + [_sha_row(16, 256 * 16 * 64, "2p14_jl"),
       _sha_row(3, 8 * 1000 + 3, "partial_block"), _sample_jl_row()]
    + [_sha_row(k, n) for k in (1, 3, 16) for n in (1, 7, 8, 9, 17, 1001)]
    + [_alpha_row(q, w) for q in ("small", "big") for w in "BACD"]
    + [_phi_alpha_row("2p14", 16), _phi_alpha_row("config1", 0)]
    + [_threefry_row(s, q, c) for s, q in (
        ("2p14", "small"), ("2p14", "big"), ("config1", "small"),
        ("config1", "big"), ("config1", "top"), ("r6k16", "small"),
        ("r6k16", "big"), ("r6k16", "top"), ("folded", "small"),
        ("folded", "big")) for c in ("ajtai", "u1", "cdD", "cdC",
                                     "ajtai_r1")]
    + [_residue_witness_row(s, q) for s, q in (
        ("2p14", "big"), ("r6k16", "big"), ("r6k16", "top"))]
    + [_threefry_row(s, q, c, cut, composed) for s in ("2p14", "config1")
       for q in ("small", "big") for c in ("ajtai", "u1", "cdD", "cdC")
       for cut, composed in (((0, 4), False), ((0, 4), True))]
    + [_table_row(s, c, cut) for s in ("2p14", "config1")
       for c in ("ajtai", "u1", "cdD", "cdC") for cut in (None, (0, 4))]
    + [_batch_row(s, B, q, c, cut) for s, B, cuts in (
        ("2p14", 4, (None, (0, 4))), ("config1", 3, (None, (0, 4), (2, 4))),
        ("k16", 3, (None, (0, 4), (2, 4))))
       for q in ("small", "big") for c in ("ajtai", "u1", "cdD", "cdC")
       for cut in cuts]
    + [_digit_mode_row(c, q, b) for c in ("u1", "cdC", "cdD")
       for q, b in DIGIT_MODES]
    + [_ajtai_edge_row(q, r) for q in ("small", "big", "top")
       for r in (1, 3, 16)])


def _need_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_case_table_covers_every_kernel():
    """Every KernelInfo of the six wrapper modules has a row (so a line in
    chip_smoke.py's kernel table), and the rows' ids are distinct."""
    infos = kernel_infos()
    assert len(infos) == 25
    assert {id(r.info) for r in ROWS} == {id(k) for k in infos}
    assert len({r.id for r in ROWS}) == len(ROWS)


def test_digit_rows_cover_each_limb_mode():
    """The digit-limb rows take each mode they claim: 1 and 2 limbs at
    small q, 1 to 4 at big q."""
    for q, base in DIGIT_MODES:
        assert u1_cuda.digit_limbs(base) == DIGIT_LIMBS[base]
    assert {DIGIT_LIMBS[b] for q, b in DIGIT_MODES if not is_big(q)} == {1, 2}
    assert {DIGIT_LIMBS[b] for q, b in DIGIT_MODES if is_big(q)} == {
        1, 2, 3, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("row", ROWS, ids=[r.id for r in ROWS])
def test_kernel_matches_plain(row):
    _need_card()
    case = row.make("cuda")
    before = row.info.launches
    got = case.kernel()
    torch.cuda.synchronize()
    assert row.info.launches - before == row.launches
    want = case.plain()
    assert got.shape == want.shape and torch.equal(got, want)
    for name, call in case.also.items():
        assert torch.equal(call(), got), name


@pytest.mark.cuda
@pytest.mark.parametrize("q", [8191, 4294967311])
def test_cuda_stream_kernels_raise_beyond_limbs(q):
    """The u1 and C/D kernels flag a digit one beyond their limbs as they
    load it, and the wrappers raise after the launch."""
    _need_card()
    p = LabradorParams(n=13, r=15, q=q, k_count=51, l_count=1,
                       kappa_override=16, exact_digits=True)
    object.__setattr__(p, "b_1", 9)              # one digit limb
    object.__setattr__(p, "b_2", 9)
    crs = CRS.create(p, 0xC0DE)
    over = u1_cuda.limb_cover(1) + 1
    t_dig = torch.zeros((p.t_1, p.r, p.kappa, p.d), dtype=torch.int64)
    t_dig[1, 2, 3, 4] = -over
    h = torch.zeros((p.t_1, p.r, p.r, p.d), dtype=torch.int64)
    h[0, 5, 6, 7] = over
    h_str = _tri_stream(h.to("cuda") % q, p)
    with pytest.raises(ValueError, match="beyond"):
        u1_cuda.u1_bterm(crs, (t_dig % q).to("cuda"))
    with pytest.raises(ValueError, match="beyond"):
        cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1)
    h_str[h_str == over] = over - 1                  # within the limb
    assert torch.equal(cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
                       cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1))


# ---------------------------------------------------------------------------
# flows on the card
# ---------------------------------------------------------------------------

def _launched(fn):
    """fn()'s result, and each kernel's launches during it by name."""
    infos = kernel_infos()
    before = [k.launches for k in infos]
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches - b for k, b in zip(infos, before)}


def _of_modulus(big: bool) -> list:
    """The KernelInfos whose launches come only at one size of q (kernel
    1 is small-q only: at big q the ring products take the CRT route)."""
    if big:
        return [alpha_cuda.KERNEL_BIG] + [
            k for m in COMMIT_MODULES
            for k in (m.KERNEL_BIG, m.KERNEL_RANGE_BIG, m.KERNEL_BATCH_BIG)]
    return [polymul_cuda.KERNEL, alpha_cuda.KERNEL] + [
        k for m in COMMIT_MODULES
        for k in (m.KERNEL, m.KERNEL_RANGE, m.KERNEL_TABLE, m.KERNEL_BATCH)]


def _check_launches(launched: dict, big: bool, recursion_: bool = False,
                    extra=()) -> None:
    """The commitment kernels of the modulus launched (kernel 1 and the
    alpha-contraction kernel too in a recursion flow), and no kernel of
    the other modulus."""
    need = [m.KERNEL_BIG if big else m.KERNEL for m in COMMIT_MODULES]
    if recursion_:
        need += [alpha_cuda.KERNEL_BIG] if big else [polymul_cuda.KERNEL,
                                                     alpha_cuda.KERNEL]
    assert all(launched[k.name] for k in list(need) + list(extra)), launched
    assert not any(launched[k.name] for k in _of_modulus(not big)), launched


def _check_table_only(launched: dict) -> None:
    """The table modes of kernels 2-4 launched, and no other mode."""
    for m in COMMIT_MODULES:
        assert launched[m.KERNEL_TABLE.name], launched
        assert not any(launched[v.name] for v in vars(m).values()
                       if isinstance(v, cuda_lib.KernelInfo)
                       and v is not m.KERNEL_TABLE), launched


def _matches(want: dict, p, proof, report) -> None:
    """The fields of a golden record that ``want`` holds, from the port's
    proof (the sizes computed only where the record has them)."""
    have = {
        "transcript_sha256": lambda: structs.transcript_sha256(proof, p.q),
        "transcript_size_in_bytes": lambda: structs.transcript_size_in_bytes(
            proof, p.q),
        "transcript_size_in_bytes_fs": lambda:
            structs.transcript_size_in_bytes(proof, p.q, fs=True),
        "verify_report": lambda: report,
        **{k: (lambda k=k: getattr(p, k)) for k in (
            "n", "r", "k_count", "kappa", "beta_override")}}
    for key, value in want.items():
        assert have[key]() == value, key


def _check_folded(res) -> None:
    f = res.folded
    assert res.report["all"] and f is not None, res.report
    assert f.residual == 0
    assert bool(f.proof.jl_ok) and bool(f.proof.b_pp_ok)
    assert all(f.report.values()), f.report
    assert f.recursive_report["all"], f.recursive_report


# the transcript fields that the reference simulator derives
REFSIM_FIELDS = ("t", "g", "u_1", "projection", "b_prime_prime", "h", "u_2",
                 "z")


def _golden_chacha() -> None:
    """prove and prove_fs on config 1's ChaCha CRS equal the golden record;
    the reference simulator derives the same transcript fields and its
    verifier accepts; only the table modes of kernels 2-4 launch."""
    def run():
        inst = chacha_proofs("cuda")
        return inst, chacha_record(*inst)

    (inst, got), launched = _launched(run)
    want = json.loads((GOLDEN / "config1_chacha.json").read_text())
    for part in ("table_sha256", "prove", "prove_fs"):
        assert got[part] == want[part], part
    _check_table_only(launched)
    p, crs, witness, state, proof, _ = inst
    ref = refsim.ref_prove(p, witness, state, crs,
                           refsim.extract_challenges(proof))
    for field in REFSIM_FIELDS:
        assert np.array_equal(getattr(proof, field).cpu().numpy(),
                              ref[field]), field
    assert refsim.ref_verify(p, state, proof, crs)["all"]


GOLDEN_FLOWS = ["interactive", "big_q", "recursion", "big_q_recursion",
                "fs_small_q", "fs_big_q", "fs_recursion", "chacha"]


def golden_flow(name: str) -> None:
    """``cli`` at config 1 on the card (interactive, ``--big-q``, ``-R``,
    ``--big-q -R`` at kappa 16, ``--fs`` at both moduli, ``--fs -R``, and
    prove / prove_fs on the ChaCha CRS) equals the JAX package's golden
    record; a tampered z fails check 15, a tampered folded witness leaves
    a residual; the kernels of the modulus launch, none of the other's."""
    big, rec = "big_q" in name, "recursion" in name
    if name == "chacha":
        return _golden_chacha()
    if name.startswith("fs"):
        mode = "recursion" if rec else "big_q" if big else "small_q"
        got, launched = _launched(lambda: port_fs_flow(
            big_q=big, recursive=rec, device="cuda"))
        assert got == json.loads((GOLDEN / "config1_fs.json").read_text())[
            mode]
        return _check_launches(launched, big, rec)
    golden = json.loads((GOLDEN / ("config1_bigq.json" if big else
                                   "config1_recursion.json" if rec else
                                   "config1.json")).read_text())
    if big and rec:
        golden = golden["recursion"]
    cfg = golden["config"]
    res, launched = _launched(lambda: run_flow(
        cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
        recursion=rec, big_q=big))
    p = res.params
    _matches(golden.get("base", {k: v for k, v in golden.items()
                                 if k != "config"}),
             p, res.proof, res.report)
    assert all(res.report.values()), res.report
    _check_launches(launched, big, rec)
    if rec:
        _check_folded(res)
        f = res.folded
        _matches(golden["folded"], f.params, f.proof, f.report)
        w_bad = f.witness.clone()
        w_bad[0, 0, 0] += 1
        assert recursion.folded_residual(f.state, w_bad, f.params) != 0
        return
    bad_z = res.proof.z.clone()
    # at big q one low 16-bit limb changes (tests/test_bigq_pipeline.py)
    bad_z[0, 0] = ((bad_z[0, 0] >> 16 << 16) | ((bad_z[0, 0] + 1) & 0xFFFF)
                   if big else (bad_z[0, 0] + 1) % p.q)
    rep = verifier.verify_report(p, res.state, res.proof.replace(z=bad_z),
                                 res.crs, "exact" if big else "reference")
    assert not rep["c15_az_vs_ct"] and not rep["all"]


def _flow_cli(big: bool, kind: str) -> None:
    """``cli`` at 2^14 (interactive, ``-R`` or ``--fs``) at q = 8191 or
    4294967311: every check true and the kernels of the modulus launched;
    at q = 8191 the commitments reduced.  ``-R`` at big q also proves the
    fold with mu = 16 through ``prove_recursive`` / ``verify_recursive``
    (the fold cell's path), its four alpha passes a launch each;
    ``--fs``'s prove_fs and verify_fs launch the stream kernel once each
    and prove_fs is deterministic."""
    res, launched = _launched(lambda: run_flow(
        **REAL, seed=42, device="cuda", recursion=kind == "recursion",
        fs=kind == "fs", big_q=big))
    p = res.params
    mode = "exact" if big else "reference"
    assert bool(res.proof.jl_ok) and bool(res.proof.b_pp_ok)
    assert res.report["all"] and all(res.report.values()), res.report
    if not big:
        for name in ("u_1", "u_2", "t", "z"):
            x = getattr(res.proof, name)
            assert bool(torch.all((x >= 0) & (x < p.q))), name
    _check_launches(launched, big, kind == "recursion",
                    [sha_cuda.KERNEL] if kind == "fs" else ())
    if kind == "recursion":
        _check_folded(res)
        if big:
            def fold16():
                rp = prover.prove_recursive(
                    p, res.witness, res.state, res.crs, res.verifier_key,
                    mu=16, base=res.proof)
                return verifier.verify_recursive(p, res.state, rp, res.crs,
                                                 mu=16)
            rep, counted = _launched(fold16)
            assert rep["all"] and all(rep.values()), rep
            # A, B, C and D in the folded prove and in the folded verify
            assert counted[alpha_cuda.KERNEL_BIG.name] == 8, counted
    if kind != "fs":
        return
    proof, in_prove = _launched(lambda: prover.prove_fs(
        p, res.witness, res.state, res.crs, mode))
    ok, in_verify = _launched(lambda: verifier.verify_fs(
        p, res.state, proof, res.crs, decomp_mode=mode))
    assert ok
    assert structs.transcript_sha256(proof, p.q) == \
        structs.transcript_sha256(res.proof, p.q)
    for counted in (in_prove, in_verify):
        assert counted[sha_cuda.KERNEL.name] == 1    # one JL attempt
        _check_launches(counted, big)


class _Preempted(Exception):
    pass


@contextlib.contextmanager
def _stopped_in(name: str):
    """prover.<name> raises _Preempted while the context lasts."""
    def stop(*a, **k):
        raise _Preempted

    saved = getattr(prover, name)
    setattr(prover, name, stop)
    try:
        yield
    finally:
        setattr(prover, name, saved)


def _flow_phases_ckpt() -> None:
    """``cli --phases`` at 2^14: the phased proof equals ``prove``'s; with
    a checkpoint, a run stopped in phase 2 (or 3) and resumed from its
    phase-1 (or phase-2) checkpoint does too."""
    from labrador_tpu_torch.utils import checkpoint

    res, launched = _launched(lambda: run_flow(**REAL, seed=42,
                                               device="cuda", phases=True))
    assert res.ok, res.report
    _check_launches(launched, False)
    p = res.params
    args = (p, res.witness, res.state, res.crs, res.verifier_key)
    want = structs.transcript_sha256(prover.prove(*args), p.q)
    assert structs.transcript_sha256(res.proof, p.q) == want
    with tempfile.TemporaryDirectory() as tmp:
        for stop_in, saved in (("prove_phase2a", 1), ("prove_phase3", 2)):
            path = str(Path(tmp) / f"ckpt{saved}.npz")
            with _stopped_in(stop_in), pytest.raises(_Preempted):
                prover.prove_checkpointed(*args, ckpt_path=path)
            assert checkpoint.load_meta(path)["phases_done"] == saved
            resumed = prover.prove_checkpointed(*args, ckpt_path=path)
            assert structs.transcript_sha256(resumed, p.q) == want


def _flow_chacha() -> None:
    """2^14 on the ChaCha CRS (26,279,936 table entries), prove and
    verify with the sampler's witness: every check true, only the table
    modes of kernels 2-4 launched."""
    p = LabradorParams(**SHAPES["2p14"])
    crs = MaterializedCRS.create_chacha(p, CHACHA_SEED, "cuda")
    kw, ks, kv = keys.split(keys.key(42), 3)
    witness = sampling.generate_witness(kw, p, "cuda")
    state = structs.generate_state(ks, witness, p)

    def run():
        proof = prover.prove(p, witness, state, crs, kv)
        return proof, verifier.verify_report(p, state, proof, crs)

    (proof, report), launched = _launched(run)
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    assert all(report.values()), report
    _check_table_only(launched)


def _flow_batch(p, seeds, mode: str, oracle: str,
                golden: str | None = None) -> None:
    """``prove_batch`` of the CLI's instances at ``seeds``: every instance
    equals its single prove field by field (instance 0 the ``golden``
    digest where given), ``verify_report_batch`` is all true, and each
    batch call launches the batch modes as often as one single prove and
    verify launch the plain modes: one launch a call site, not one an
    instance."""
    big = is_big(p.q)
    insts = [make_instance(p, s, "cuda") for s in seeds]
    w = torch.stack([i[0] for i in insts])
    st = structs.stack([i[1] for i in insts])
    crs_b = CRSBatch.stack([i[2] for i in insts], device="cuda")
    tr, in_prove = _launched(lambda: prover.prove_batch(
        p, w, st, crs_b, [i[3] for i in insts], oracle, mode))
    rep, in_verify = _launched(lambda: verifier.verify_report_batch(
        p, st, tr, crs_b, mode))
    assert all(bool(v.all()) for v in rep.values()), rep
    if golden is not None:
        assert structs.transcript_sha256(structs.take(tr, 0), p.q) == golden
    for i, (w1, st1, crs1, kv) in enumerate(insts):
        single, counted = _launched(
            lambda: prover.prove_fs(p, w1, st1, crs1, mode) if oracle == "fs"
            else prover.prove(p, w1, st1, crs1, kv, mode))
        if i == 0:
            one = counted
        got = structs.take(tr, i)
        diff = [f for f in single.__dataclass_fields__
                if not torch.equal(getattr(got, f), getattr(single, f))]
        assert not diff, (i, diff)
    _, one_verify = _launched(lambda: verifier.verify_report(
        p, insts[0][1], structs.take(tr, 0), insts[0][2], mode))
    for batch, single in ((in_prove, one), (in_verify, one_verify)):
        for m in COMMIT_MODULES:
            b_info, s_info = ((m.KERNEL_BATCH_BIG, m.KERNEL_BIG) if big
                              else (m.KERNEL_BATCH, m.KERNEL))
            assert batch[b_info.name] == single[s_info.name]
            assert batch[b_info.name] and not batch[s_info.name]
        assert not any(batch[k.name] for k in _of_modulus(not big))


def _flow_batch_config1() -> None:
    """``prove_batch`` of 16 config-1 instances (seeds 42 .. 57, the port
    bench's batch) with either oracle, instance 0 at its golden digest."""
    p = make_params(2, 2)
    golden = {"interactive": json.loads((GOLDEN / "config1.json").read_text())[
        "transcript_sha256"], "fs": json.loads((GOLDEN / "config1_fs.json")
                                               .read_text())["small_q"][
        "transcript_sha256"]}
    for oracle in ("interactive", "fs"):
        _flow_batch(p, range(42, 58), "reference", oracle, golden[oracle])


def _flow_jl_projection() -> None:
    """``prover.jl_projection`` of a random signed int32 witness of 2^23
    coefficients (above the 4,194,303 where it once stopped) by a random
    ternary int8 pi (r = 2, 256 rows): a few rows exactly equal to numpy
    int64 on the host (the JAX package's limbs, int32-wrapping limb dots,
    the recombination's low word)."""
    r, m = 2, (1 << 23) // 2
    gen = torch.Generator(device="cuda").manual_seed(0x1A)
    pi = torch.randint(-1, 2, (r, 256, m), dtype=torch.int8, device="cuda",
                       generator=gen)
    w = torch.randint(-(1 << 31), 1 << 31, (r, m), dtype=torch.int64,
                      device="cuda", generator=gen)
    (proj, _), launched = _launched(lambda: prover.jl_projection(pi, w))
    assert not any(launched.values())
    v = w.cpu().numpy().astype(np.int32).astype(np.int64)
    limbs_np = []
    for _ in range(4):
        limb = ((v + 128) & 255) - 128
        limbs_np.append(limb)
        v = (v - limb) >> 8
    for row in (0, 1, 128, 255):
        pr = pi[:, row].cpu().numpy().astype(np.int64)
        acc = 0
        for k in (3, 2, 1, 0):
            dot = int(np.sum(pr * limbs_np[k]))
            acc = acc * 256 + (dot + (1 << 31)) % (1 << 32) - (1 << 31)
        assert int(proj[row]) == (acc + (1 << 31)) % (1 << 32) - (1 << 31)


FLOWS_2P14 = {
    "interactive": lambda: _flow_cli(False, "interactive"),
    "recursion": lambda: _flow_cli(False, "recursion"),
    "fs": lambda: _flow_cli(False, "fs"),
    "bigq_interactive": lambda: _flow_cli(True, "interactive"),
    "bigq_recursion": lambda: _flow_cli(True, "recursion"),
    "bigq_fs": lambda: _flow_cli(True, "fs"),
    "phases_ckpt": _flow_phases_ckpt,
    "chacha": _flow_chacha,
    "batch_bigq8": lambda: _flow_batch(
        make_params(REAL["n"], REAL["r"], REAL["kappa"], False, True),
        range(42, 50), "exact", "interactive"),
    "batch_config1_16": _flow_batch_config1,
    "jl_projection": _flow_jl_projection,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDEN_FLOWS)
def test_golden_flow(name):
    """``golden_flow(name)`` on the card."""
    _need_card()
    golden_flow(name)


@pytest.mark.cuda
@pytest.mark.parametrize("flow", list(FLOWS_2P14))
def test_flow_2p14(flow):
    """One 2^14 flow on the card (each asserts its results and launches);
    nothing here is timed."""
    _need_card()
    FLOWS_2P14[flow]()

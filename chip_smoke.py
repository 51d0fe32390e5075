"""Smoke run of the PyTorch + CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version (kernels 2-4 in their small-q
and their big-q mode), proves and verifies config 1 against the JAX
package's golden transcript, proves and verifies the 2^14-coefficient
instance (BASELINE.json config 3), runs the recursion flow (``cli -R``:
prove, fold, prove and verify the folded instance) at config 1 against the
JAX golden digests and at the 2^14 base, and does the same at the
2^32-scale modulus (``cli --big-q``, with and without ``-R``); every
alpha-contraction of those flows takes the kernel (``ops/alpha_cuda``),
and its three passes are held bit-equal to their plain versions at the
2^14 base.  Also runs
the JL projection on a witness of 8,388,608 coefficients, above the
4,194,303 where the port's projection used to stop, exact on the rows it
checks against numpy.  Then the Fiat-Shamir mode (``cli --fs``): the
SHA-256 stream kernel held equal to hashlib, config-1 ``--fs`` at both
moduli and ``--fs -R`` against the JAX golden file, and ``prove_fs`` /
``verify_fs`` at 2^14 at both moduli; and phased, checkpointed proving
(``cli --phases`` / ``--ckpt``) at 2^14, resumed after each phase.  Last,
multi-device proving (``labrador_tpu_torch/parallel/``): the range modes
of kernels 2-4 at the 2^14 shapes in 4 shards, each bit-equal to its
plain version and the shards composed equal to the unranged kernel; then
a world of 4 spawned ranks sharing the card over gloo proves config 1 on
a dp 2 x rows 2 mesh against the JAX golden digests (both moduli, both
oracles), 2^14 on rows 4 and BASELINE.json config 4 (2^20, big q) on rows
2 against single-rank runs, the sharded verifier beside, each rank's
launch counts showing the range modes.  Last, batched proving
(``prover.prove_batch``, ``verifier.verify_report_batch``): the batch
modes of kernels 2-4 bit-equal to their plain versions and to single
launches (config 1 at B = 3, 2^14 at B = 4, both moduli, whole and shard
0 of 4), 8 2^14 ``--big-q`` instances and 16 config-1 instances (both
oracles) proved in one batch, each equal to its single prove with one
launch a call site, and the port's bench (``python -m
labrador_tpu_torch.bench``) in its own process.

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py

Every phase raises on failure, so the script exits non-zero; without a
CUDA device it exits non-zero before printing any result.  The line before
the last lists each kernel with its launches in the 2^14 runs of the main
paths (``-R``, ``--fs`` and ``--phases`` at its modulus; for a range mode
the 2^14 sharded proves, summed over the ranks; for a table mode the
ChaCha phase's proves and verifies; for a batch mode the batched proves
and verifies of the batch phase at its modulus), its time beside the
plain version's, a library call's and its bound; the last line of
standard output is the result JSON.  Imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "config1.json"
GOLDEN_R = ROOT / "labrador_tpu_torch" / "golden" / "config1_recursion.json"
GOLDEN_BIG = ROOT / "labrador_tpu_torch" / "golden" / "config1_bigq.json"
GOLDEN_FS = ROOT / "labrador_tpu_torch" / "golden" / "config1_fs.json"
REAL = dict(n=16, r=16, kappa=256)       # BASELINE.json config 3
BIG_Q = dict(q_start=(1 << 32) - 1, exact_digits=True)   # cli --big-q
TIMED_RUNS = 3
POLY_PRODUCTS = 100_000                  # BASELINE.json config 2
POLY_TAIL = 99_999                       # not a multiple of 32 (COEF_TILE)
POLY_SERVING = 65_536                    # bench.py's fixed-operand batch
POLY_SERVING_TAIL = 65_531               # not a multiple of 8 (BHAT_ROWS)

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3 at
# 3.35 TB/s; int8 tensor-core operations at 1,979 T/s; int32 operations
# outside the tensor cores at 132 SMs x 64 INT32 lanes x the 1.98 GHz boost
# clock, one IMAD per lane per clock.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one Threefry-2x32 block (20 rounds of add, rotate,
# xor; 5 key injections of 3 adds), the least work per CRS entry
THREEFRY_OPS = 20 * 3 + 5 * 3
# int32 instructions of one SHA-256 stream block (csrc/sha_stream.cu) with
# three-input logic (LOP3) and adds (IADD3) and one-instruction rotations
# (SHF): 64 rounds of 14 (two 3-rotation sigmas and their xor, 4 each;
# choose and majority, 1 each; 4 adds), 48 schedule steps of 10 (two sigmas
# of 2 rotations, a shift and their xor; 2 adds), the 8 adds of H0; less
# the 53 that fold where a word of the message (dom, the padding) or of the
# state (H0) is a constant
SHA_OPS = 64 * 14 + 48 * 10 + 8 - 53


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def limbs(max_abs: int) -> int:
    """8-bit limbs an int8 tensor-core product needs for |x| <= max_abs."""
    return 1 if max_abs <= 127 else -(-max_abs.bit_length() // 8)


class Work:
    """What one call must do: bytes (each input read once, each output
    written once), int32 operations that only the CUDA cores can do
    (Threefry), and multiply-adds of small integers, each of which int8
    tensor cores can do as limb_products limb products of two
    operations."""

    def __init__(self, nbytes: float, int32_ops: float, macs: float,
                 limb_products: int, mac_ops: int = 1,
                 tpu_limb_products: int | None = None):
        self.nbytes, self.int32_ops = nbytes, int32_ops
        self.macs, self.limb_products = macs, limb_products
        self.mac_ops = mac_ops
        # the limb products of the TPU kernel's own scheme, where it does
        # more than the function needs (per CRT prime at big q): printed
        # beside the bound, not used in it
        self.tpu_limb_products = tpu_limb_products

    def bound(self, limb_products: int | None = None) -> tuple[float, str]:
        """The least time (ms) the card could take: the larger of the bytes
        over the memory rate and the operations over their peak rates
        (Threefry on the CUDA cores, multiply-adds on int8 tensor cores)."""
        lp = self.limb_products if limb_products is None else limb_products
        t_bytes = self.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(self.int32_ops / INT32_OPS_PER_S,
                    2 * self.macs * lp / INT8_TC_OPS_PER_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def cuda_core_ms(self) -> float:
        """The same bound with the multiply-adds on the CUDA cores
        (mac_ops int32 operations each: one IMAD for a product below 2^31,
        more for a wider one), printed beside the bound: the commitment
        kernels take them on int8 tensor cores."""
        return max(self.nbytes / HBM_BYTES_PER_S,
                   (self.int32_ops + self.macs * self.mac_ops)
                   / INT32_OPS_PER_S) * 1e3

    def describe(self) -> str:
        bound_ms, bound_by = self.bound()
        tpu = ""
        if self.tpu_limb_products is not None:
            tpu = (f"; with the TPU kernel's {self.tpu_limb_products} limb "
                   f"products {self.bound(self.tpu_limb_products)[0]:.4f} ms")
        return (f"bound {bound_ms:.4f} ms ({bound_by}, {self.limb_products} "
                f"limb products; CUDA-core bound "
                f"{self.cuda_core_ms():.4f} ms{tpu})")


def _sync() -> None:
    torch.cuda.synchronize()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return card


def phase_build() -> None:
    from labrador_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    loaded = cuda_lib.load()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(library {cuda_lib.source_hash()})")
    kernel = ""
    for line in loaded.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        if "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")


def _kernel_name(line: str) -> str:
    """The kernel's name and first template argument in a ptxas line, out
    of the mangled name (a length-prefixed identifier ending in kernel)."""
    for m in re.finditer(r"\d+", line):
        end = m.end() + int(m[0])
        if line[m.end():end].endswith("kernel"):
            arg = re.match(r"ILi(\d+)E", line[end:])
            return line[m.end():end] + (f"<{arg[1]}>" if arg else "")
    return ""


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to("cuda")


# int32 operations of one big-q multiply-add on the CUDA cores: a 64-bit
# product of the centred entry and operand (both below 1.25 * 2^31 for q <
# 2^32 + 2^30), two wide IMADs, and its 128-bit accumulation, two adds with
# carry.  Above that q the kernel takes a 128-bit product, about twice the
# operations, and the CUDA-core bound printed there is low.
BIG_MAC_OPS = 4
# the largest prime below 2^33, the top of the big-q range: the kernels'
# products of two centred values reach 2^64 there
TOP_Q_START = (1 << 33) - 9


def _kernel_info(mod, q: int):
    """The KernelInfo of a wrapper module's kernel in the mode of q."""
    from labrador_tpu_torch.ops.zq import is_big
    return mod.KERNEL_BIG if is_big(q) else mod.KERNEL


def _kernel_inputs(p, seed: int, crs=None) -> SimpleNamespace:
    """The commitment kernels' operands at the shapes of instance ``p``
    from a fixed numpy seed (``_kernel_cases`` says which), the CRS (a
    Threefry one from the seed unless ``crs`` is given), and ``work``, the
    Work of one stream contraction."""
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.ops import ajtai_cuda, ntt
    from labrador_tpu_torch.ops.zq import is_big
    from labrador_tpu_torch.protocol import _tri_stream

    if crs is None:
        crs = CRS.create(p, seed=0xC0FFEE + seed)
    rng = np.random.default_rng(seed)
    d = p.d
    big = is_big(p.q)

    def signed(top: int, shape):
        x = rng.integers(-top, top + 1, shape)
        x.reshape(-1)[:2] = [top, -top]
        return x

    def digits(base: int, shape):
        x = signed(base // 2, shape)
        return _t(x if big else x % p.q)

    def work(rows: int, L: int, nrhs: int, max_rhs: int,
             lp: int | None = None) -> Work:
        """One stream contraction: digits in and result out; one
        Threefry block per CRS entry and d multiply-adds per entry and
        right-hand side (entries below max_rhs in size).  Limb products:
        ``lp`` where given (the Ajtai kernel's own: its entry limbs times
        its witness limbs), else those of the direct product with no CRT,
        the entry's limbs (a residue below q at small q; centred, at most
        q/2, at big q) against the operand's.  At big q the Pallas kernel
        does more, per CRT prime 2 limbs of the entry's residue against
        the operand's; that count is printed beside the bound."""
        entries = rows * L * d
        tpu_lp = None
        if big:
            tpu_lp = ntt.plan_for(p).n_primes * 2 * limbs(max_rhs)
        if lp is None:
            lp = limbs(p.q // 2 if big else p.q - 1) * limbs(max_rhs)
        return Work(8 * d * nrhs * (L + rows), entries * THREEFRY_OPS,
                    entries * d * nrhs, lp, BIG_MAC_OPS if big else 1,
                    tpu_lp)

    if big:
        w_max = p.q // 2
        w = signed(w_max, (p.r, p.n, p.d))
        w.reshape(-1)[2] = -(1 << 31)
    else:
        w_max = p.q - 1
        w = rng.integers(0, p.q, (p.r, p.n, p.d))
    w = _t(w)
    t_dig = digits(p.b_1, (p.t_1, p.r, p.kappa, p.d))
    g_str = _tri_stream(digits(p.b_2, (p.t_2, p.r, p.r, p.d)), p)
    h_str = _tri_stream(digits(p.b_1, (p.t_1, p.r, p.r, p.d)), p)
    aj_lp = ajtai_cuda.entry_limbs(p.q) * ajtai_cuda.witness_limbs(p.q)
    return SimpleNamespace(crs=crs, w=w, w_max=w_max, t_dig=t_dig,
                           g_str=g_str, h_str=h_str, work=work, aj_lp=aj_lp)


def _kernel_cases(p, seed: int):
    """(kernel module, label, kernel fn, plain fn, Work) at the shapes of
    instance ``p``, on inputs from a fixed numpy seed.  Small q: random
    residues for Ajtai, random centred digits lifted mod q for the u1
    B-term and the C/D sums.  Big q, the JAX package's convention there:
    signed operands at their magnitude bounds, an Ajtai witness up to q/2
    (the most the kernel takes, beyond the JAX package's int32 witness),
    -2^31 among them (it reaches check 15 as the int32 wrap of an
    oversized z), and digits up to +-b/2, the bounds present."""
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda

    x = _kernel_inputs(p, seed)
    crs, w, w_max, t_dig = x.crs, x.w, x.w_max, x.t_dig
    g_str, h_str, work, aj_lp = x.g_str, x.h_str, x.work, x.aj_lp
    n_tri = p.r * (p.r + 1) // 2
    return [
        (ajtai_cuda, "ajtai r_eff=r",
         lambda: ajtai_cuda.ajtai_commit(crs, w),
         lambda: ajtai_cuda.ajtai_commit_plain(crs, w),
         work(p.kappa, p.n, p.r, w_max, aj_lp)),
        (ajtai_cuda, "ajtai r_eff=1",
         lambda: ajtai_cuda.ajtai_commit(crs, w[:1]),
         lambda: ajtai_cuda.ajtai_commit_plain(crs, w[:1]),
         work(p.kappa, p.n, 1, w_max, aj_lp)),
        (u1_cuda, "u1 B-term",
         lambda: u1_cuda.u1_bterm(crs, t_dig),
         lambda: u1_cuda.u1_bterm_plain(crs, t_dig),
         work(p.kappa_1, p.r * p.t_1 * p.kappa, 1, p.b_1 // 2)),
        (cd_cuda, "cd D-term (u2)",
         lambda: cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
         lambda: cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1),
         work(p.kappa_2, n_tri * p.t_1, 1, p.b_1 // 2)),
        (cd_cuda, "cd C-term (u1)",
         lambda: cd_cuda.cd_sum(crs, g_str, crs._off_c, p.t_2, p.b_2),
         lambda: cd_cuda.cd_sum_plain(crs, g_str, crs._off_c, p.t_2),
         work(p.kappa_2, n_tri * p.t_2, 1, p.b_2 // 2)),
    ]


def hold_kernels(p, label_size: str, stats: dict | None = None,
                 plain_reps: int = 2) -> None:
    """Kernels 2-4 against their plain versions at the shapes of instance
    ``p`` (in the mode of its modulus); bit-equality required.  Where
    ``stats`` is given, records each kernel's error there, and the times
    and bound of its first case."""
    for mod, label, kern, plain, work in _kernel_cases(p, seed=7):
        got, want = kern(), plain()
        _sync()
        err = int(torch.max(torch.abs(got - want)))
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{label} at {label_size}: kernel != "
                                 f"plain (max abs err {err})")
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, plain_reps)
        log(f"kernel {label:16s} {label_size:13s} {str(tuple(got.shape)):15s}"
            f" bit-equal (tolerance 0)  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {work.describe()}; at "
            f"{work.bound()[0] / ms:.1%} of the bound")
        if stats is None:
            continue
        st = stats.setdefault(_kernel_info(mod, p.q).name, {"max_abs_err": 0})
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if "ms" not in st:
            bound_ms, bound_by = work.bound()
            # no single PyTorch call expands the Threefry CRS and
            # contracts it: library_ms stays null
            st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)


def phase_kernels() -> dict:
    """Kernels 2-4 against their plain versions at the config-1 and the
    2^14 shapes, at small and at big q, and at the config-1 shapes at the
    largest prime below 2^33.  Returns per-kernel error and the times and
    bound of its first case at the 2^14 shapes (Ajtai at r_eff = r, the u1
    B-term, the u2 D-term)."""
    from labrador_tpu_torch.params import LabradorParams
    stats: dict = {}
    for extra, tag in (({}, ""), (BIG_Q, " big-q")):
        hold_kernels(LabradorParams(n=2, r=2, **extra), "config1" + tag)
        hold_kernels(LabradorParams(n=REAL["n"], r=REAL["r"],
                                    kappa_override=REAL["kappa"], **extra),
                     "2^14" + tag, stats)
    top = LabradorParams(n=2, r=2, **{**BIG_Q, "q_start": TOP_Q_START})
    hold_kernels(top, f"config1 q={top.q}", stats)
    return stats


def _negacyclic_conv1d(a: torch.Tensor, b: torch.Tensor):
    """The yardstick of kernel 1: one grouped float64 F.conv1d computing
    the exact integer negacyclic products a[i] (*) b[i] (before the
    reduction mod q); returns the call and a check of its result."""
    n, d = a.shape
    x = torch.cat([-b, b], dim=1).to(torch.float64).reshape(1, n, 2 * d)
    wgt = torch.flip(a, dims=(1,)).to(torch.float64).reshape(n, 1, d)

    def call():
        return torch.nn.functional.conv1d(x, wgt, groups=n)

    def result(q: int) -> torch.Tensor:
        return torch.remainder(call()[0, :, 1:d + 1].to(torch.int64), q)

    return call, result


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def polymul_cases() -> tuple[list, dict]:
    """Kernel 1's cases on the card, (label, products, kernel fn, plain fn,
    Work) each, and its yardsticks: BASELINE.json config 2 (10^5 products,
    coefficient operands) and 99,999 products (a partial final block), the
    fixed-operand serving shape (65,536 products against bhat (P, 1, 64)),
    the same fixed operand over 65,531 rows (a partial final tile), random
    canonical per-prime residues over 65,531 rows (a per-row bhat; Garner
    beyond the image of the forward transform), and the ring products of
    the 2^14 -R path (FoldedState.phi_alpha_modq and fold at n = r = 16).
    Yardsticks: {"conv1d": (call, check) of config 2, "matmul": (call,
    check) of the serving shape}, each check True when the call's result
    mod q equals the kernel's.  Also run by kernel_times.py against a
    parent checkout's package: it uses only the wrappers' public names."""
    from labrador_tpu_torch.ops import ntt, polymul_cuda
    from labrador_tpu_torch.ops.ring_stream import circulant
    from labrador_tpu_torch.params import LabradorParams

    p = LabradorParams(n=2, r=2)
    plan = ntt.plan_for(p)
    P, q, d = plan.n_primes, p.q, p.d
    rng = np.random.default_rng(2)
    a = _t(rng.integers(0, q, (POLY_PRODUCTS, d)))
    b = _t(rng.integers(0, q, (POLY_PRODUCTS, d)))
    a_s = a[:POLY_SERVING].contiguous()
    a_t, b_t = a[:POLY_TAIL].contiguous(), b[:POLY_TAIL].contiguous()
    a_st = a[:POLY_SERVING_TAIL].contiguous()
    bhat_fixed = ntt.ntt_fwd(b[:1], plan)                     # (P, 1, d)
    pv = np.asarray(plan.primes).reshape(P, 1, 1)
    bhat_rand = _t(rng.integers(0, 1 << 62, (P, POLY_SERVING_TAIL, d)) % pv)
    n0 = r0 = REAL["n"]
    vec = _t(rng.integers(0, q, (d,)))                         # a16..a18
    cphi = _t(rng.integers(0, q, (n0, d)))
    cc = _t(rng.integers(0, q, (r0, r0, d)))
    c = _t(rng.integers(0, q, (r0, d)))
    coef = polymul_cuda.negacyclic_polymul
    coef_plain = polymul_cuda.negacyclic_polymul_plain
    bh = polymul_cuda.negacyclic_polymul_bhat
    bh_plain = polymul_cuda.negacyclic_polymul_bhat_plain
    lp_q = limbs(q - 1) ** 2
    lp_p = limbs(max(plan.primes) - 1) ** 2

    def coef_case(label, x, y):
        n_out = torch.Size(torch.broadcast_shapes(x.shape, y.shape)).numel() \
            // d
        return (label, n_out, lambda: coef(x, y, plan),
                lambda: coef_plain(x, y, plan),
                Work(8 * d * (_rows(x) + _rows(y) + n_out), 0,
                     n_out * d * d, lp_q))

    def bhat_case(label, x, bhat):
        n = _rows(x)
        return (label, n, lambda: bh(x, bhat, plan),
                lambda: bh_plain(x, bhat, plan),
                Work(8 * d * (2 * n + _rows(bhat)), 0, n * P * 2 * d * d,
                     lp_p))

    cases = [
        coef_case("config 2: 10^5 products", a, b),
        coef_case(f"config 2 tail: {POLY_TAIL} products", a_t, b_t),
        bhat_case("serving: bhat (P, 1, 64)", a_s, bhat_fixed),
        bhat_case(f"bhat (P, 1, 64), {POLY_SERVING_TAIL} rows", a_st,
                  bhat_fixed),
        bhat_case(f"bhat random residues, {POLY_SERVING_TAIL} rows", a_st,
                  bhat_rand),
        coef_case("-R a17 * cphi: (d,) x (16, d)", vec, cphi),
        coef_case("-R a16 * cc: (d,) x (16, 16, d)", vec, cc),
        coef_case("-R fold cc: (16, 1, d) x (1, 16, d)", c[:, None],
                  c[None, :]),
    ]
    conv_call, conv_result = _negacyclic_conv1d(a, b)
    # the serving case's yardstick: one float64 matmul of the rows by the
    # 64 x 64 negacyclic matrix of b (exact: 64 q^2 < 2^53), b taken
    # back from bhat and its matrix built once, outside the timed call
    nb = circulant(ntt.ntt_inv_modq(bhat_fixed, plan)[0]).to(torch.float64)
    a_f = a_s.to(torch.float64)

    def serving_mm():
        return torch.matmul(a_f, nb)

    yard = {
        "conv1d": (conv_call,
                   lambda: torch.equal(conv_result(q), coef(a, b, plan))),
        "matmul": (serving_mm, lambda: torch.equal(
            torch.remainder(serving_mm().to(torch.int64), q),
            bh(a_s, bhat_fixed, plan))),
    }
    return cases, yard


def _test_module(name: str):
    """A JAX-free module of tests/, for its case lists and flows."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def coef_edge_cases() -> list:
    """Edge inputs of kernel 1's coefficient variant, (label, plan, a, b)
    on the card: the input kinds of ``tests/test_torch_coef_kernel.py``
    (the same as its ``cuda`` test's) at q = 8191 (no flush) and q = 32513
    (a flush every 8 terms): int64 extremes and values outside [-q, q)
    (the 64-bit Barrett path), zero rows, one product, a partial tile,
    each operand fixed (row stride 0), the fold's outer broadcast, and
    operands the wrapper copies (transposed, off the 16-byte alignment, a
    broadcast over three axes).  Held against the plain version of the
    operands' residues mod q: the plain version takes |x| < q, beyond
    which its CRT transforms wrap."""
    from labrador_tpu_torch.ops import ntt

    tests = _test_module("test_torch_coef_kernel")
    cases = []
    for q in (8191, 32513):
        plan = ntt.make_plan(q)
        for kind in tests.KINDS:
            a, b = tests.coef_inputs(
                q, kind, np.random.default_rng(q + len(kind)), "cuda")
            cases.append((f"q {q}: {kind}", plan, a, b))
    return cases


def phase_polymul() -> dict:
    """Kernel 1 against its plain versions on the card at the cases of
    ``polymul_cases``; bit-equality required.  Times each beside its bound,
    and the yardsticks.  Returns the config-2 case's numbers for the
    kernels line."""
    from labrador_tpu_torch.ops import polymul_cuda

    cases, yard = polymul_cases()
    stats: dict = {"max_abs_err": 0}
    for label, count, kern, plain, work in cases:
        got, want = kern(), plain()
        _sync()
        err = int(torch.max(torch.abs(got - want)))
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"polymul {label}: kernel != plain (max abs "
                                 f"err {err})")
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        log(f"kernel polymul {label:38s} {str(tuple(got.shape)):14s} "
            f"bit-equal (tolerance 0)  kernel {ms:.4f} ms = "
            f"{count / ms * 1e3:.4g} products/s  plain {plain_ms:.4f} ms  "
            f"{work.describe()}; at {work.bound()[0] / ms:.1%} of the bound")
        if "ms" not in stats:
            bound_ms, bound_by = work.bound()
            stats.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    edges = coef_edge_cases()
    for label, plan, a, b in edges:
        got = polymul_cuda.negacyclic_polymul(a, b, plan)
        want = polymul_cuda.negacyclic_polymul_plain(
            torch.remainder(a, plan.q), torch.remainder(b, plan.q), plan)
        _sync()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"polymul edge case {label}: kernel != "
                                 f"plain")
    log(f"kernel polymul coefficient edge cases: {len(edges)} "
        f"bit-equal (tolerance 0)")
    for name, (call, check) in yard.items():
        if not check():
            raise AssertionError(f"the {name} yardstick disagrees with "
                                 f"kernel 1")
    stats["library_ms"] = cuda_ms(yard["conv1d"][0], 5)
    log(f"kernel polymul config 2 yardstick: one float64 grouped conv1d "
        f"(exact integer products, no mod q) {stats['library_ms']:.4f} ms")
    log(f"kernel polymul serving yardstick: one float64 matmul "
        f"({POLY_SERVING}, 64) @ (64, 64) (exact integer products, no mod q) "
        f"{cuda_ms(yard['matmul'][0], 20):.4f} ms")
    return stats


def _kernels():
    """Every kernel of the port, each mode of kernels 2-4 apart (small q,
    big q, the range mode of each, the table mode, and the batch mode at
    each modulus), the SHA-256 stream kernel and the alpha-contraction
    kernel at each modulus."""
    from labrador_tpu_torch.ops import (ajtai_cuda, alpha_cuda, cd_cuda,
                                        polymul_cuda, sha_cuda, u1_cuda)
    mods = (ajtai_cuda, u1_cuda, cd_cuda)
    return ([polymul_cuda.KERNEL, sha_cuda.KERNEL, alpha_cuda.KERNEL,
             alpha_cuda.KERNEL_BIG]
            + [m.KERNEL for m in mods]
            + [m.KERNEL_BIG for m in mods] + [m.KERNEL_RANGE for m in mods]
            + [m.KERNEL_RANGE_BIG for m in mods]
            + [m.KERNEL_TABLE for m in mods]
            + [m.KERNEL_BATCH for m in mods]
            + [m.KERNEL_BATCH_BIG for m in mods])


def _reset_counts() -> None:
    for k in _kernels():
        k.launches = 0


def _counts() -> dict:
    return {k.name: k.launches for k in _kernels()}


def _require_launched(counts: dict, names, where: str) -> None:
    missing = [n for n in names if not counts[n]]
    if missing:
        raise AssertionError(f"{where}: kernels {missing} not launched "
                             f"({counts})")


COMMITMENT_KERNELS = ("ajtai_commit", "u1_bterm", "cd_sum")
ALL_KERNELS = ("negacyclic_polymul",) + COMMITMENT_KERNELS
# at big q the ring products take the CRT route (kernel 1 is small-q only,
# as in the JAX package), so these are the big-q path's kernels
BIG_KERNELS = ("ajtai_commit_bigq", "u1_bterm_bigq", "cd_sum_bigq")
# and a recursion flow's, the alpha-contraction kernel besides
RECURSION_KERNELS = ALL_KERNELS + ("alpha_contract",)
BIG_RECURSION_KERNELS = BIG_KERNELS + ("alpha_contract_bigq",)


def phase_config1() -> None:
    """Config 1 on cuda: transcript digest, sizes and report equal the JAX
    package's golden values; tampered z fails check 15; every commitment
    kernel launches in prove and in verify."""
    from labrador_tpu_torch import keys, prover, structs, verifier
    from labrador_tpu_torch.cli import run_flow

    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda")
    p, proof = res.params, res.proof
    digest = structs.transcript_sha256(proof, p.q)
    if digest != golden["transcript_sha256"]:
        raise AssertionError(f"config-1 transcript digest {digest} != JAX "
                             f"golden {golden['transcript_sha256']}")
    sizes = [structs.transcript_size_in_bytes(proof, p.q),
             structs.transcript_size_in_bytes(proof, p.q, fs=True)]
    if sizes != [golden["transcript_size_in_bytes"],
                 golden["transcript_size_in_bytes_fs"]]:
        raise AssertionError(f"config-1 sizes {sizes} != golden")
    if res.report != golden["verify_report"] or not all(res.report.values()):
        raise AssertionError(f"config-1 report {res.report}")
    bad_z = proof.z.clone()
    bad_z[0, 3] = (bad_z[0, 3] + 1) % p.q
    rep_bad = verifier.verify_report(p, res.state, proof.replace(z=bad_z),
                                     res.crs)
    if rep_bad["c15_az_vs_ct"] or rep_bad["all"]:
        raise AssertionError("tampered z was not rejected by check 15")

    kv = keys.split(keys.key(cfg["seed"]), 3)[2]
    _reset_counts()
    prover.prove(p, res.witness, res.state, res.crs, kv)
    in_prove = _counts()
    _reset_counts()
    verifier.verify_report(p, res.state, proof, res.crs)
    in_verify = _counts()
    _sync()
    _require_launched(in_prove, COMMITMENT_KERNELS, "config-1 prove")
    _require_launched(in_verify, COMMITMENT_KERNELS, "config-1 verify")
    log(f"config1: transcript sha256 {digest} == JAX golden; size "
        f"{sizes[0]} B (fs {sizes[1]} B) == golden; all checks true; "
        f"tampered z rejected (c15)")
    log(f"config1: launches in prove {in_prove}, in verify {in_verify}")
    prove_s, verify_s = _timed_runs(dict(n=cfg["n"], r=cfg["r"],
                                         kappa=cfg["kappa"]))
    log(f"config1: prove {prove_s * 1e3:.2f} ms, verify {verify_s * 1e3:.2f} "
        f"ms (median of {TIMED_RUNS} after one warm-up, host clock after "
        f"sync); first run prove {res.prove_s * 1e3:.2f} ms verify "
        f"{res.verify_s * 1e3:.2f} ms")


def _timed_runs(shape: dict) -> tuple[float, float]:
    """Median prove and verify seconds of TIMED_RUNS further runs."""
    from labrador_tpu_torch.cli import run_flow
    runs = [run_flow(**shape, seed=42, device="cuda")
            for _ in range(TIMED_RUNS)]
    return (statistics.median(r.prove_s for r in runs),
            statistics.median(r.verify_s for r in runs))


def phase_real() -> None:
    """The 2^14 instance end to end; its commitment kernels must launch."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda")
    launches = _counts()
    _require_launched(launches, COMMITMENT_KERNELS, "2^14 prove + verify")
    p = res.params
    if not (bool(res.proof.jl_ok) and bool(res.proof.b_pp_ok)):
        raise AssertionError("2^14 prover self-checks failed")
    if not all(res.report.values()):
        failed = [k for k, v in res.report.items() if not v]
        raise AssertionError(f"2^14 verification failed: {failed}")
    for name in ("u_1", "u_2", "t", "z"):
        x = getattr(res.proof, name)
        if not bool(torch.all((x >= 0) & (x < p.q))):
            raise AssertionError(f"2^14 transcript field {name} out of range")
    prove_s, verify_s = _timed_runs(REAL)
    size = structs.transcript_size_in_bytes(res.proof, p.q)
    size_fs = structs.transcript_size_in_bytes(res.proof, p.q, fs=True)
    log(f"2^14 ({' '.join(f'{k}={v}' for k, v in REAL.items())}): all "
        f"checks true; launches {launches}")
    log(f"2^14: prove {prove_s * 1e3:.2f} ms, verify {verify_s * 1e3:.2f} "
        f"ms (median of {TIMED_RUNS} after one warm-up, host clock after "
        f"sync); first run "
        f"prove {res.prove_s * 1e3:.2f} ms verify {res.verify_s * 1e3:.2f} ms")
    log(f"2^14: proof {size} B = {size / 1024:.2f} KB (fs metric {size_fs} B)")


def _check_folded(res, where: str) -> None:
    f = res.folded
    if not res.report["all"] or f is None:
        raise AssertionError(f"{where}: base proof failed: {res.report}")
    if f.residual != 0:
        raise AssertionError(f"{where}: folded residual {f.residual} != 0")
    if not (bool(f.proof.jl_ok) and bool(f.proof.b_pp_ok)):
        raise AssertionError(f"{where}: folded prover self-checks failed")
    if not all(f.report.values()):
        failed = [k for k, v in f.report.items() if not v]
        raise AssertionError(f"{where}: folded verification failed: {failed}")
    if not f.recursive_report["all"]:
        raise AssertionError(f"{where}: verify_recursive rejected: "
                             f"{f.recursive_report}")


def phase_recursion_config1() -> None:
    """``cli -R`` at config 1: base and folded transcript SHA-256, the
    folded params, fs size and report equal the JAX golden file; the
    folded residual is 0 and a tampered folded witness gives a nonzero
    one; kernel 1 launches in the fold, the folded prove and the folded
    verify, kernels 2-4 in the folded prove."""
    from labrador_tpu_torch import keys, prover, recursion, structs, verifier
    from labrador_tpu_torch.cli import FOLDED_CRS_XOR, run_flow
    from labrador_tpu_torch.crs import CRS

    golden = json.loads(GOLDEN_R.read_text())
    cfg, gb, gf = golden["config"], golden["base"], golden["folded"]
    _reset_counts()
    e0 = _alpha_marks()
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
                   recursion=True)
    launches = _counts()
    _require_launched(launches, RECURSION_KERNELS, "config-1 -R")
    _require_alpha_kernel(e0, "config-1 -R")
    _check_folded(res, "config-1 -R")
    f = res.folded
    p, p2 = res.params, f.params
    got = {
        "base sha256": structs.transcript_sha256(res.proof, p.q),
        "folded sha256": structs.transcript_sha256(f.proof, p2.q),
        "folded fs size": structs.transcript_size_in_bytes(f.proof, p2.q,
                                                           fs=True),
        "folded shape": [p2.n, p2.r, p2.k_count, p2.kappa, p2.beta_override],
        "base report": res.report, "folded report": f.report,
    }
    want = {
        "base sha256": gb["transcript_sha256"],
        "folded sha256": gf["transcript_sha256"],
        "folded fs size": gf["transcript_size_in_bytes_fs"],
        "folded shape": [gf[k] for k in ("n", "r", "k_count", "kappa",
                                         "beta_override")],
        "base report": gb["verify_report"], "folded report": gf["verify_report"],
    }
    for key in got:
        if got[key] != want[key]:
            raise AssertionError(f"config-1 -R {key}: {got[key]} != JAX "
                                 f"golden {want[key]}")
    w_bad = f.witness.clone()
    w_bad[0, 0, 0] = (w_bad[0, 0, 0] + 1) % p2.q
    if recursion.folded_residual(f.state, w_bad, p2) == 0:
        raise AssertionError("config-1 -R: tampered folded witness accepted")

    # each step alone, counted
    _reset_counts()
    p2b, w2, s2, _ = recursion.fold(p, res.state, res.proof, res.crs)
    in_fold = _counts()
    crs2 = CRS.create(p2b, seed=cfg["seed"] ^ FOLDED_CRS_XOR)
    _reset_counts()
    proof2 = prover.prove(p2b, w2, s2, crs2, keys.fold_in(res.verifier_key, 1),
                          decomp_mode="exact")
    in_prove = _counts()
    _reset_counts()
    verifier.verify_report(p2b, s2, proof2, crs2, decomp_mode="exact")
    in_verify = _counts()
    _sync()
    for counts, where in ((in_fold, "fold"), (in_prove, "folded prove"),
                          (in_verify, "folded verify")):
        _require_launched(counts, ("negacyclic_polymul",),
                          f"config-1 -R {where}")
    _require_launched(in_prove, COMMITMENT_KERNELS, "config-1 -R folded prove")
    log(f"config1 -R: base sha256 {got['base sha256']}, folded sha256 "
        f"{got['folded sha256']} == JAX golden; folded n'={p2.n} r'={p2.r} "
        f"k'={p2.k_count}, fs size {got['folded fs size']} B == golden; "
        f"residual 0, tampered witness rejected; all checks true")
    log(f"config1 -R: launches in the flow {launches}; fold {in_fold}, "
        f"folded prove {in_prove}, folded verify {in_verify}")
    log(f"config1 -R: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms, fold {f.fold_s * 1e3:.2f} ms, folded "
        f"prove {f.prove_s * 1e3:.2f} ms, folded verify "
        f"{f.verify_s * 1e3:.2f} ms (first run, host clock after sync)")


def phase_recursion_real(stats: dict) -> dict:
    """``cli -R`` at the 2^14 base (n = r = 16, kappa = 256): fold, prove
    and verify with every check true; then kernels 2-4 held bit-equal to
    their plain versions at the folded instance's shapes (r' = 180,
    n' = 175, kappa' = 16, 16,290 C/D pairs) on random inputs, their
    errors merged into ``stats``.  Returns the launches of the run, the
    kernels line's counts."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    e0 = _alpha_marks()
    res = run_flow(**REAL, seed=42, device="cuda", recursion=True)
    launches = _counts()
    _require_launched(launches, RECURSION_KERNELS, "2^14 -R")
    alpha_share = _require_alpha_kernel(e0, "2^14 -R")
    _check_folded(res, "2^14 -R")
    f = res.folded
    p, p2 = res.params, f.params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sizes = (structs.transcript_size_in_bytes(res.proof, p.q),
             structs.transcript_size_in_bytes(res.proof, p.q, fs=True),
             structs.transcript_size_in_bytes(f.proof, p2.q, fs=True))
    log(f"2^14 -R: all checks true; folded n'={p2.n} r'={p2.r} "
        f"k'={p2.k_count} beta'={p2.beta_override}; launches {launches}; "
        f"{alpha_share}")
    log(f"2^14 -R: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms, fold {f.fold_s * 1e3:.2f} ms, folded "
        f"prove {f.prove_s * 1e3:.2f} ms, folded verify "
        f"{f.verify_s * 1e3:.2f} ms (host clock after sync); peak device "
        f"memory {peak_gb:.2f} GB")
    log(f"2^14 -R: proof base {sizes[0]} B (fs {sizes[1]} B) -> folded fs "
        f"{sizes[2]} B (the folded interactive size, 516 M JL entries of "
        f"bincode, is not computed)")
    # the folded witness is all zero (beta' = 1), so the run above cannot
    # tell a kernel from one that writes zeros: random inputs here
    hold_kernels(p2, "2^14 -R'", stats, plain_reps=1)

    hold_alpha_passes(f.state, "2^14 -R", stats)
    _profile_folded_prove(res)
    return launches


def _alpha_marks():
    """A copy of ``recursion.ALPHA_EXPANSION`` and the alpha-contraction
    kernels' launches so far, for ``_require_alpha_kernel``."""
    from labrador_tpu_torch import recursion
    from labrador_tpu_torch.ops import alpha_cuda
    return (dataclasses.replace(recursion.ALPHA_EXPANSION),
            alpha_cuda.KERNEL.launches + alpha_cuda.KERNEL_BIG.launches)


def _require_alpha_kernel(marks, where: str) -> str:
    """Every alpha-contraction since ``marks`` (``_alpha_marks``) launched
    the kernel: the calls that ``recursion.ALPHA_EXPANSION`` counts, the
    calls it counts at a launch and the kernels' launches are one number;
    returns the share as a line's part."""
    from labrador_tpu_torch import recursion
    e0, n0 = marks
    e1 = recursion.ALPHA_EXPANSION
    calls, kern = e1.calls - e0.calls, e1.kernel_calls - e0.kernel_calls
    entries = e1.kernel_entries - e0.kernel_entries
    launched = _alpha_marks()[1] - n0
    if not calls or not kern == launched == calls:
        raise AssertionError(f"{where}: {kern} of {calls} alpha-"
                             f"contractions took the kernel ({launched} "
                             f"launches)")
    return (f"alpha-contraction kernel share {kern / calls:.1f} ({kern} of "
            f"{calls} calls, {entries} base-CRS entries)")


def hold_alpha_passes(st, label: str, stats: dict) -> None:
    """The three passes of one ``phi_alpha_modq`` (``ops/alpha_cuda``: A,
    B, and C and D apart) at the base shapes of FoldedState ``st``, each
    held bit-equal to its plain version on random weights with the edge
    residues 0, 1, +-(q - 1)/2, q - 1 in, and timed with CUDA events
    against its bound (the entries' Threefry, the weights in and the sums
    out; the weights' limbs as many as the entries', both centred at big
    q); the B pass's times recorded in ``stats`` under the kernel's name.
    Then the whole ``phi_alpha_modq`` on the kernel route, host clock."""
    from labrador_tpu_torch.ops import alpha_cuda
    from labrador_tpu_torch.ops.zq import is_big

    crs, p0 = st.base_crs, st.layout.params
    q, d, big = p0.q, p0.d, is_big(p0.q)
    n_tri = p0.r * (p0.r + 1) // 2
    rng = np.random.default_rng(11)

    def weights(L: int) -> torch.Tensor:
        x = rng.integers(0, q, (L, d))
        x.reshape(-1)[:5] = [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]
        return _t(x)

    wa, wb, wc = weights(p0.kappa), weights(p0.kappa_1), weights(p0.kappa_2)
    top = q // 2 if big else q - 1
    passes = (
        ("alpha A", lambda: alpha_cuda.alpha_a(crs, wa),
         lambda: alpha_cuda.alpha_a_plain(crs, wa), p0.n, p0.kappa),
        ("alpha B", lambda: alpha_cuda.alpha_b(crs, wb),
         lambda: alpha_cuda.alpha_b_plain(crs, wb),
         p0.r * p0.t_1 * p0.kappa, p0.kappa_1),
        ("alpha C", lambda: alpha_cuda.alpha_cd(crs, crs._off_c, wb, p0.t_2),
         lambda: alpha_cuda.alpha_cd_plain(crs, crs._off_c, wb, p0.t_2),
         n_tri * p0.t_2, p0.kappa_2),
        ("alpha D", lambda: alpha_cuda.alpha_cd(crs, crs._off_d, wc, p0.t_1),
         lambda: alpha_cuda.alpha_cd_plain(crs, crs._off_d, wc, p0.t_1),
         n_tri * p0.t_1, p0.kappa_2),
    )
    info = alpha_cuda.KERNEL_BIG if big else alpha_cuda.KERNEL
    for name, kern, plain, rows, L in passes:
        got, want = kern(), plain()
        _sync()
        err = int(torch.max(torch.abs(got - want)))
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{name} at {label}: kernel != plain (max "
                                 f"abs err {err})")
        entries = rows * L * d
        work = Work(8 * d * (L + rows), entries * THREEFRY_OPS, entries * d,
                    limbs(top) ** 2, BIG_MAC_OPS if big else 1)
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 1)
        log(f"kernel {name:16s} {label:13s} {str(tuple(got.shape)):15s} "
            f"bit-equal (tolerance 0)  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {entries} entries, {work.describe()}; at "
            f"{work.bound()[0] / ms:.1%} of the bound")
        if name == "alpha B":
            bound_ms, bound_by = work.bound()
            stats[info.name] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None}
    alpha = weights(st.layout.k_new)
    st.phi_alpha_modq(alpha)
    ms, _ = _host_ms(lambda: st.phi_alpha_modq(alpha))
    log(f"{label}: phi_alpha_modq {ms:.2f} ms on the kernel route (median, "
        f"host clock after sync)")


def _require_big_only(counts: dict, where: str,
                      recursion: bool = False) -> None:
    """A big-q run launches the big-q kernels (a recursion flow's with
    ``recursion``), and no small-q one."""
    _require_launched(counts, BIG_RECURSION_KERNELS if recursion
                      else BIG_KERNELS, where)
    small = [n for n in RECURSION_KERNELS if counts[n]]
    if small:
        raise AssertionError(f"{where}: small-q kernels {small} launched "
                             f"({counts})")


def phase_bigq_config1() -> None:
    """``cli --big-q`` at config 1: transcript digest, sizes and report
    equal the JAX golden file; z with one low 16-bit limb changed (the
    tamper of tests/test_bigq_pipeline.py) fails check 15; the big-q
    kernels launch in prove and in verify."""
    from labrador_tpu_torch import keys, prover, structs, verifier
    from labrador_tpu_torch.cli import run_flow

    golden = json.loads(GOLDEN_BIG.read_text())
    cfg, gb = golden["config"], golden["base"]
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
                   big_q=True)
    p, proof = res.params, res.proof
    if p.q != cfg["q"]:
        raise AssertionError(f"--big-q modulus {p.q} != {cfg['q']}")
    got = [structs.transcript_sha256(proof, p.q),
           structs.transcript_size_in_bytes(proof, p.q),
           structs.transcript_size_in_bytes(proof, p.q, fs=True), res.report]
    want = [gb["transcript_sha256"], gb["transcript_size_in_bytes"],
            gb["transcript_size_in_bytes_fs"], gb["verify_report"]]
    if got != want or not all(res.report.values()):
        raise AssertionError(f"config-1 --big-q {got} != JAX golden {want}")
    bad_z = proof.z.clone()
    bad_z[0, 0] = (bad_z[0, 0] >> 16 << 16) | ((bad_z[0, 0] + 1) & 0xFFFF)
    rep_bad = verifier.verify_report(p, res.state, proof.replace(z=bad_z),
                                     res.crs, "exact")
    if rep_bad["c15_az_vs_ct"] or rep_bad["all"]:
        raise AssertionError("--big-q: tampered z was not rejected")

    kv = keys.split(keys.key(cfg["seed"]), 3)[2]
    _reset_counts()
    prover.prove(p, res.witness, res.state, res.crs, kv, "exact")
    in_prove = _counts()
    _reset_counts()
    verifier.verify_report(p, res.state, proof, res.crs, "exact")
    in_verify = _counts()
    _sync()
    _require_big_only(in_prove, "config-1 --big-q prove")
    _require_big_only(in_verify, "config-1 --big-q verify")
    log(f"config1 --big-q (q = {p.q}): transcript sha256 {got[0]} == JAX "
        f"golden; size {got[1]} B (fs {got[2]} B) == golden; all checks "
        f"true; tampered z rejected (c15)")
    log(f"config1 --big-q: launches in prove {in_prove}, in verify "
        f"{in_verify}")
    log(f"config1 --big-q: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms (first run, host clock after sync)")


def _nonzero_share(x: torch.Tensor) -> float:
    return float((x != 0).double().mean())


def phase_bigq_real() -> None:
    """``cli --big-q`` at 2^14 (n = r = 16, kappa = 256): a realistic
    witness (more than half of its entries nonzero, unlike q = 8191's),
    prove and verify with every check true through the big-q kernels."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda", big_q=True)
    launches = _counts()
    _require_big_only(launches, "2^14 --big-q prove + verify")
    p = res.params
    share = _nonzero_share(res.witness)
    if share <= 0.5:
        raise AssertionError(f"2^14 --big-q witness only {share:.3f} nonzero")
    if not (bool(res.proof.jl_ok) and bool(res.proof.b_pp_ok)):
        raise AssertionError("2^14 --big-q prover self-checks failed")
    if not all(res.report.values()):
        failed = [k for k, v in res.report.items() if not v]
        raise AssertionError(f"2^14 --big-q verification failed: {failed}")
    runs = [run_flow(**REAL, seed=42, device="cuda", big_q=True)
            for _ in range(TIMED_RUNS)]
    prove_s = statistics.median(r.prove_s for r in runs)
    verify_s = statistics.median(r.verify_s for r in runs)
    size = structs.transcript_size_in_bytes(res.proof, p.q)
    size_fs = structs.transcript_size_in_bytes(res.proof, p.q, fs=True)
    log(f"2^14 --big-q (q = {p.q}, t1={p.t_1}/b1={p.b_1}, "
        f"t2={p.t_2}/b2={p.b_2}): witness {share:.4f} nonzero; all checks "
        f"true; launches {launches}")
    log(f"2^14 --big-q: prove {prove_s * 1e3:.2f} ms, verify "
        f"{verify_s * 1e3:.2f} ms (median of {TIMED_RUNS} after one warm-up,"
        f" host clock after sync); first run prove {res.prove_s * 1e3:.2f} "
        f"ms verify {res.verify_s * 1e3:.2f} ms")
    log(f"2^14 --big-q: proof {size} B = {size / 1024:.2f} KB (fs metric "
        f"{size_fs} B)")


def phase_bigq_recursion_config1() -> None:
    """``cli --big-q -R --kappa 16`` at config 1 (the golden file's
    recursion part, generated at kappa = 16 to keep its JAX regeneration
    short): base and folded digests, folded params and fs size equal the
    JAX golden file; the folded residual is 0 and a tampered folded
    witness gives a nonzero one; the big-q kernels launch in the folded
    prove and verify."""
    from labrador_tpu_torch import recursion, structs
    from labrador_tpu_torch.cli import run_flow

    g = json.loads(GOLDEN_BIG.read_text())["recursion"]
    cfg, gb, gf = g["config"], g["base"], g["folded"]
    _reset_counts()
    e0 = _alpha_marks()
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
                   recursion=True, big_q=True)
    launches = _counts()
    _require_big_only(launches, "config-1 --big-q -R", recursion=True)
    _require_alpha_kernel(e0, "config-1 --big-q -R")
    _check_folded(res, "config-1 --big-q -R")
    f = res.folded
    p, p2 = res.params, f.params
    got = {
        "base sha256": structs.transcript_sha256(res.proof, p.q),
        "base fs size": structs.transcript_size_in_bytes(res.proof, p.q,
                                                         fs=True),
        "folded sha256": structs.transcript_sha256(f.proof, p2.q),
        "folded fs size": structs.transcript_size_in_bytes(f.proof, p2.q,
                                                           fs=True),
        "folded shape": [p2.n, p2.r, p2.k_count, p2.kappa, p2.beta_override],
    }
    want = {
        "base sha256": gb["transcript_sha256"],
        "base fs size": gb["transcript_size_in_bytes_fs"],
        "folded sha256": gf["transcript_sha256"],
        "folded fs size": gf["transcript_size_in_bytes_fs"],
        "folded shape": [gf[k] for k in ("n", "r", "k_count", "kappa",
                                         "beta_override")],
    }
    for key in got:
        if got[key] != want[key]:
            raise AssertionError(f"config-1 --big-q -R {key}: {got[key]} != "
                                 f"JAX golden {want[key]}")
    w_bad = f.witness.clone()
    w_bad[0, 0, 0] += 1
    if recursion.folded_residual(f.state, w_bad, p2) == 0:
        raise AssertionError("--big-q -R: tampered folded witness accepted")
    log(f"config1 --big-q -R (kappa {cfg['kappa']}): base sha256 "
        f"{got['base sha256']}, folded sha256 {got['folded sha256']} == JAX "
        f"golden; folded n'={p2.n} r'={p2.r} k'={p2.k_count}, fs size "
        f"{got['folded fs size']} B == golden; residual 0, tampered witness "
        f"rejected; all checks true; launches {launches}")
    log(f"config1 --big-q -R: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms, fold {f.fold_s * 1e3:.2f} ms, folded "
        f"prove {f.prove_s * 1e3:.2f} ms, folded verify "
        f"{f.verify_s * 1e3:.2f} ms (first run, host clock after sync)")


def phase_bigq_recursion_real(stats: dict) -> dict:
    """``cli --big-q -R`` at the 2^14 base (n = r = 16, kappa = 256): fold,
    prove and verify with every check true, fs sizes and peak memory; then
    kernels 2-4 in big-q mode held bit-equal to their plain versions at
    the folded instance's shapes on random operands at their bounds, their
    errors merged into ``stats``; and the fold with mu = 16, the size
    record of the TPU rounds, through ``prover.prove_recursive`` and
    ``verifier.verify_recursive``.  Returns the launches of the run, the
    kernels line's counts of the big-q kernels."""
    from labrador_tpu_torch import prover, recursion, structs, verifier
    from labrador_tpu_torch.cli import run_flow

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    e0 = _alpha_marks()
    res = run_flow(**REAL, seed=42, device="cuda", recursion=True,
                   big_q=True)
    launches = _counts()
    _require_big_only(launches, "2^14 --big-q -R", recursion=True)
    alpha_share = _require_alpha_kernel(e0, "2^14 --big-q -R")
    _check_folded(res, "2^14 --big-q -R")
    f = res.folded
    p, p2 = res.params, f.params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sizes = (structs.transcript_size_in_bytes(res.proof, p.q, fs=True),
             structs.transcript_size_in_bytes(f.proof, p2.q, fs=True))
    log(f"2^14 --big-q -R: all checks true; witness "
        f"{_nonzero_share(res.witness):.4f} nonzero, folded witness "
        f"{_nonzero_share(f.witness):.4f}; folded n'={p2.n} r'={p2.r} "
        f"k'={p2.k_count} kappa'={p2.kappa} beta'={p2.beta_override} "
        f"t1'={p2.t_1}/b1'={p2.b_1} t2'={p2.t_2}/b2'={p2.b_2}; launches "
        f"{launches}; {alpha_share}")
    log(f"2^14 --big-q -R: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms, fold {f.fold_s * 1e3:.2f} ms, folded "
        f"prove {f.prove_s * 1e3:.2f} ms, folded verify "
        f"{f.verify_s * 1e3:.2f} ms (host clock after sync); peak device "
        f"memory {peak_gb:.2f} GB")
    log(f"2^14 --big-q -R: fs size base {sizes[0]} B -> folded {sizes[1]} B")
    _profile_folded_prove(res, "2^14 --big-q -R")
    hold_kernels(p2, "2^14 -R' big-q", stats, plain_reps=1)
    hold_alpha_passes(f.state, "2^14 big-q", stats)

    # the fold of the TPU rounds' size record (PERF.md): mu = 16 witness
    # vectors for the digit stream instead of the CLI's round(sqrt(.)),
    # through prove_recursive / verify_recursive (no base opening)
    from labrador_tpu_torch.utils.profiling import PhaseTimer
    timer = PhaseTimer("cuda")
    e0 = _alpha_marks()
    rp = prover.prove_recursive(p, res.witness, res.state, res.crs,
                                res.verifier_key, mu=16, timer=timer,
                                base=res.proof)
    rep3 = verifier.verify_recursive(p, res.state, rp, res.crs, mu=16,
                                     timer=timer)
    e1 = recursion.ALPHA_EXPANSION
    if not rep3["all"] or not all(rep3.values()):
        raise AssertionError(f"2^14 --big-q -R mu=16 failed: {rep3}")
    alpha_share = _require_alpha_kernel(e0, "2^14 --big-q -R mu=16")
    p3 = recursion.folded_params(recursion.make_layout(p, 16), 16,
                                 rp.beta_new)
    log(f"2^14 --big-q -R mu=16: folded n'={p3.n} r'={p3.r}, "
        f"verify_recursive all true; fs size {sizes[0]} B -> "
        f"{structs.transcript_size_in_bytes(rp.folded, p3.q, fs=True)} B "
        f"folded, {rp.transcript_size_in_bytes(p.q, fs=True)} B recursive "
        f"proof; alpha-contractions {e1.calls - e0[0].calls} calls, "
        f"{e1.entries - e0[0].entries} base-CRS entries, {alpha_share}; "
        f"sections (ms) "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in timer.phases.items()))
    return launches


def _profile_folded_prove(res, label: str = "2^14 -R") -> None:
    """A second folded prove under cProfile: host-clock cumulative seconds
    of the phases and of the steps that take most of them (device work
    shows up where the host waits for it)."""
    import cProfile
    import pstats

    from labrador_tpu_torch import keys, prover
    f = res.folded
    prof = cProfile.Profile()
    _sync()
    t0 = time.perf_counter()
    prof.enable()
    prover.prove(f.params, f.witness, f.state, f.crs,
                 keys.fold_in(res.verifier_key, 1), decomp_mode="exact")
    _sync()
    prof.disable()
    wall = time.perf_counter() - t0
    cum = {}
    for (_, _, fn), row in pstats.Stats(prof).stats.items():
        cum[fn] = max(cum.get(fn, 0.0), row[3])
    names = ("prove_phase1", "prove_phase2a", "prove_phase2b",
             "prove_phase3", "sample_challenges", "sample_jl",
             "jl_project", "jl_projection", "aggregate_phi_pp",
             "phi_alpha_modq", "_alpha_contract_b", "ajtai_commit",
             "u1_from_digits", "u2_from_digits", "gram_hat")
    log(f"{label} folded prove under cProfile: {wall * 1e3:.2f} ms wall; "
        "cumulative s: " + ", ".join(f"{n} {cum.get(n, 0.0):.3f}"
                                     for n in names))


JL_COEFFS = 1 << 23                     # 8,388,608 witness coefficients
JL_ROWS_CHECKED = (0, 1, 128, 255)


def phase_jl_projection() -> None:
    """The JL projection (``prover.jl_projection``) of a random signed
    int32 witness of JL_COEFFS coefficients by a random ternary int8 pi
    (r = 2, 256 rows) on the card: a few rows held exactly against numpy
    int64 on the host (the JAX package's limbs, int32-wrapping limb dots,
    emulated i64 recombination and low word), the time and the peak device
    memory above pi's own bytes."""
    from labrador_tpu_torch import prover

    r, m = 2, JL_COEFFS // 2
    gen = torch.Generator(device="cuda").manual_seed(0x1A)
    pi = torch.randint(-1, 2, (r, 256, m), dtype=torch.int8, device="cuda",
                       generator=gen)
    w = torch.randint(-(1 << 31), 1 << 31, (r, m), dtype=torch.int64,
                      device="cuda", generator=gen)
    prover.jl_projection(pi[:, :, :1024], w[:, :1024])   # warm-up
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    proj, fits = prover.jl_projection(pi, w)
    stop.record()
    _sync()
    ms = start.elapsed_time(stop)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9

    v = w.cpu().numpy().astype(np.int32).astype(np.int64)
    limbs_np = []
    for _ in range(4):
        limb = ((v + 128) & 255) - 128
        limbs_np.append(limb)
        v = (v - limb) >> 8
    for row in JL_ROWS_CHECKED:
        pr = pi[:, row].cpu().numpy().astype(np.int64)
        acc = 0
        for k in (3, 2, 1, 0):
            dot = int(np.sum(pr * limbs_np[k]))
            dot = (dot + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
            acc = acc * 256 + dot
        want = (acc + (1 << 31)) % (1 << 32) - (1 << 31)
        if int(proj[row]) != want:
            raise AssertionError(f"JL projection row {row}: {int(proj[row])}"
                                 f" != numpy {want}")
    log(f"JL projection: {r * m} coefficients (pi {tuple(pi.shape)} int8), "
        f"rows {list(JL_ROWS_CHECKED)} == numpy int64; fits {fits}; "
        f"{ms:.2f} ms; peak device memory {peak_gb:.3f} GB above the "
        f"inputs ({pi.numel() / 1e9:.3f} GB of pi)")


def _host_ms(fn, reps: int = TIMED_RUNS) -> tuple[float, object]:
    """Median host-clock ms of reps calls of fn(), each between device
    syncs, and the last call's result."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


SHA_PARTIAL_WORDS = 8 * 1000 + 3        # a partial final block


def phase_sha_stream() -> dict:
    """The SHA-256 stream kernel (``csrc/sha_stream.cu``, which
    ``sha_prng.stream_device`` launches on the card) held equal to hashlib
    at the 2^14 JL size (16 keys, 256 x 1024 words each: 524,288 blocks)
    and at a partial final block, one launch a call; its time (CUDA
    events, one launch) beside its bound and its plain version's
    (``stream_plain``, ``sha256_batch`` in torch ops on the card); then,
    host clock after sync, the device and the host route at the JL size,
    one 2^14 FS JL attempt (``sample_jl`` on a ShaKey: 16 splits, the
    stream, the ternary map) and the pi absorb (``hash_arrays`` of the
    attempt's 4,194,304 int8 entries).  Returns the kernel's stats for the
    kernels line."""
    import hashlib

    from labrador_tpu_torch import keys, prover
    from labrador_tpu_torch.ops import sha256, sha_cuda, sha_prng
    from labrador_tpu_torch.params import LabradorParams

    p = LabradorParams(n=REAL["n"], r=REAL["r"], kappa_override=REAL["kappa"])
    ks = [hashlib.sha256(b"chip smoke %d" % i).digest() for i in range(p.r)]
    n_jl = 256 * p.n * p.d
    host_s = {}
    for label, kk, n in (("2^14 JL", ks, n_jl),
                         ("partial final block", ks[:3], SHA_PARTIAL_WORDS)):
        t0 = time.perf_counter()
        want = sha_prng.stream_host(kk, n).astype(np.int64)
        host_s[label] = time.perf_counter() - t0
        launches = sha_cuda.KERNEL.launches
        got = sha_prng.stream_device(kk, n, "cuda").cpu().numpy()
        if sha_cuda.KERNEL.launches != launches + 1:
            raise AssertionError(f"SHA-256 stream, {label}: "
                                 f"{sha_cuda.KERNEL.launches - launches} "
                                 f"kernel launches, not 1")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"SHA-256 stream, {label}: kernel != "
                                 f"hashlib")
        log(f"sha stream {label}: {len(kk)} keys x {n} words, kernel == "
            f"hashlib (bit-equal, one launch)")
    blocks = p.r * n_jl // 8
    plain = sha_prng.stream_plain(ks, n_jl, "cuda")
    if not torch.equal(plain, sha_prng.stream_device(ks, n_jl, "cuda")):
        raise AssertionError("SHA-256 stream, 2^14 JL: kernel != plain")
    kw = torch.tensor([sha256.digest_words(k) for k in ks],
                      dtype=torch.int64, device="cuda")
    kernel_ms = cuda_ms(lambda: sha_cuda.sha_stream(kw, blocks // p.r,
                                                    sha_prng.DOM_BITS), 20)
    plain_ms = cuda_ms(lambda: sha_prng.stream_plain(ks, n_jl, "cuda"), 3)
    work = Work(nbytes=blocks * 8 * 8 + p.r * 8 * 8,
                int32_ops=blocks * SHA_OPS, macs=0, limb_products=1)
    bound_ms, bound_by = work.bound()
    log(f"kernel sha_stream       2^14 JL       ({p.r}, {n_jl}) bit-equal "
        f"(tolerance 0)  kernel {kernel_ms:.4f} ms  plain {plain_ms:.4f} ms"
        f"  bound {bound_ms:.4f} ms ({bound_by}: {SHA_OPS} int32 instructions"
        f" a block, {blocks} blocks); at {bound_ms / kernel_ms:.1%} of the "
        f"bound (CUDA events)")
    dev_ms, _ = _host_ms(lambda: sha_prng.stream_device(ks, n_jl, "cuda"))
    jl_ms, pi = _host_ms(lambda: prover.sample_jl(keys.ShaKey(ks[0]), p,
                                                  "cuda"))
    absorb_ms, _ = _host_ms(lambda: sha256.hash_arrays(ks[0], pi, domain=3))
    log(f"sha stream 2^14 JL ({blocks} blocks): kernel route {dev_ms:.2f} "
        f"ms, hashlib {host_s['2^14 JL'] * 1e3:.2f} ms (one run); one FS JL "
        f"attempt (sample_jl) {jl_ms:.2f} ms; pi absorb ({pi.numel()} "
        f"int8 entries, copy to host and hashlib) {absorb_ms:.2f} ms "
        f"(medians of {TIMED_RUNS}, host clock after sync)")
    # no single PyTorch call hashes a batch: library_ms stays null
    return {"max_abs_err": 0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_fs_config1() -> None:
    """``cli --fs`` at config 1 at q = 8191 and q = 4294967311, and ``cli
    --fs -R``, against the JAX golden file (tests/test_torch_fs_golden.py's
    record: digests, fs sizes, verify and FS reports, the folded shape);
    the commitment kernels launch in each run, kernel 1 in ``--fs -R``."""
    flows = _test_module("test_torch_fs_golden")
    golden = json.loads(GOLDEN_FS.read_text())
    for mode in ("small_q", "big_q", "recursion"):
        _reset_counts()
        got = flows.port_fs_flow(big_q=mode == "big_q",
                                 recursive=mode == "recursion",
                                 device="cuda")
        launches = _counts()
        if got != golden[mode]:
            raise AssertionError(f"config-1 --fs {mode}: {got} != JAX golden "
                                 f"{golden[mode]}")
        if mode == "big_q":
            _require_big_only(launches, "config-1 --fs --big-q")
        else:
            _require_launched(launches, RECURSION_KERNELS
                              if mode == "recursion" else COMMITMENT_KERNELS,
                              f"config-1 --fs {mode}")
        base = got["base"] if mode == "recursion" else got
        log(f"config1 --fs {mode}: sha256 {base['transcript_sha256']}, fs "
            f"size {base['transcript_size_in_bytes_fs']} B == JAX golden; "
            f"fs_challenge_report all true"
            + (f"; folded sha256 {got['folded']['transcript_sha256']} == "
               f"golden" if mode == "recursion" else "")
            + f"; launches {launches}")


def phase_fs_real(big_q: bool) -> dict:
    """``cli --fs`` at 2^14 (n = r = 16, kappa = 256): every check and FS
    check true; prove_fs and verify_fs apart, each launching the
    commitment kernels of the modulus, prove_fs deterministic; prove_fs
    against prove and fs_challenge_report timed.  Returns the launches of
    the CLI flow, for the kernels line."""
    from labrador_tpu_torch import prover, structs, verifier
    from labrador_tpu_torch.cli import run_flow

    tag = "2^14 --fs" + (" --big-q" if big_q else "")
    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda", big_q=big_q, fs=True)
    launches = _counts()
    p, st, crs = res.params, res.state, res.crs
    mode = "exact" if big_q else "reference"
    if not (bool(res.proof.jl_ok) and bool(res.proof.b_pp_ok)):
        raise AssertionError(f"{tag}: prover self-checks failed")
    if not res.ok or not all(res.report.values()):
        failed = [k for k, v in res.report.items() if not v]
        raise AssertionError(f"{tag}: verification failed: {failed}")
    _reset_counts()
    proof = prover.prove_fs(p, res.witness, st, crs, mode)
    in_prove = _counts()
    _reset_counts()
    ok = verifier.verify_fs(p, st, proof, crs, decomp_mode=mode)
    in_verify = _counts()
    _sync()
    if not ok:
        raise AssertionError(f"{tag}: verify_fs rejected a second proof")
    if structs.transcript_sha256(proof, p.q) != \
            structs.transcript_sha256(res.proof, p.q):
        raise AssertionError(f"{tag}: prove_fs is not deterministic")
    for counts, where in ((launches, "flow"), (in_prove, "prove_fs"),
                          (in_verify, "verify_fs")):
        if big_q:
            _require_big_only(counts, f"{tag} {where}")
        else:
            _require_launched(counts, COMMITMENT_KERNELS, f"{tag} {where}")
        _require_launched(counts, ("sha_stream",), f"{tag} {where}")
    # one JL attempt: the prover's stream, and the verifier's re-derivation
    for counts, where in ((in_prove, "prove_fs"), (in_verify, "verify_fs")):
        if counts["sha_stream"] != 1:
            raise AssertionError(f"{tag} {where}: {counts['sha_stream']} "
                                 f"stream kernel launches, not 1")
    fs_ms, inter_ms = [], []
    for _ in range(TIMED_RUNS):
        fs_ms.append(_host_ms(lambda: prover.prove_fs(
            p, res.witness, st, crs, mode), 1)[0])
        inter_ms.append(_host_ms(lambda: prover.prove(
            p, res.witness, st, crs, res.verifier_key, mode), 1)[0])
    report_ms, _ = _host_ms(lambda: verifier.fs_challenge_report(p, st, proof,
                                                                crs))
    verify_ms, _ = _host_ms(lambda: verifier.verify_report(p, st, proof, crs,
                                                          mode))
    log(f"{tag}: every check and FS check true; launches in the flow "
        f"{launches}, prove_fs {in_prove}, verify_fs {in_verify}")
    log(f"{tag}: prove_fs {statistics.median(fs_ms):.2f} ms against prove "
        f"{statistics.median(inter_ms):.2f} ms (medians of {TIMED_RUNS}, "
        f"taken in turns; all: {', '.join(f'{t:.2f}' for t in fs_ms)} / "
        f"{', '.join(f'{t:.2f}' for t in inter_ms)}); fs_challenge_report "
        f"{report_ms:.2f} ms, verify_report {verify_ms:.2f} ms (medians "
        f"of {TIMED_RUNS}); host clock after sync")
    log(f"{tag}: fs size "
        f"{structs.transcript_size_in_bytes(proof, p.q, fs=True)} B")
    return launches


class _Preempted(Exception):
    pass


def phase_phases_real() -> dict:
    """``cli --phases`` at 2^14: the phased proof equals ``prove``'s
    digest; with a checkpoint, a run stopped in phase 2 (or 3) and resumed
    from its phase-1 (or phase-2) checkpoint does too.  Prints each
    run's PhaseTimer report.  Returns the launches of the phased flow."""
    import tempfile

    from labrador_tpu_torch import prover, structs
    from labrador_tpu_torch.cli import run_flow
    from labrador_tpu_torch.utils import checkpoint
    from labrador_tpu_torch.utils.profiling import PhaseTimer

    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda", phases=True)
    launches = _counts()
    _require_launched(launches, COMMITMENT_KERNELS, "2^14 --phases")
    if not res.ok:
        raise AssertionError(f"2^14 --phases verification failed: "
                             f"{res.report}")
    p = res.params
    args = (p, res.witness, res.state, res.crs, res.verifier_key)
    want = structs.transcript_sha256(prover.prove(*args), p.q)
    if structs.transcript_sha256(res.proof, p.q) != want:
        raise AssertionError("2^14 --phases: phased proof != prove")
    log(f"2^14 --phases: digest == prove's {want}; launches {launches}; "
        f"PhaseTimer: " + "; ".join(res.timer.report().splitlines()))

    def stop(*a, **k):
        raise _Preempted

    with tempfile.TemporaryDirectory() as tmp:
        for stop_in, saved in (("prove_phase2a", 1), ("prove_phase3", 2)):
            path = str(Path(tmp) / f"ckpt{saved}.npz")
            real = getattr(prover, stop_in)
            setattr(prover, stop_in, stop)
            try:
                prover.prove_checkpointed(*args, ckpt_path=path)
            except _Preempted:
                pass
            finally:
                setattr(prover, stop_in, real)
            if checkpoint.load_meta(path)["phases_done"] != saved:
                raise AssertionError(f"--ckpt: no phase-{saved} checkpoint")
            timer = PhaseTimer("cuda")
            resumed = prover.prove_checkpointed(*args, ckpt_path=path,
                                                timer=timer)
            if structs.transcript_sha256(resumed, p.q) != want:
                raise AssertionError(f"--ckpt: proof resumed after phase "
                                     f"{saved} != prove")
            log(f"2^14 --ckpt: resumed after phase {saved}, digest == "
                f"prove's; PhaseTimer: "
                + "; ".join(timer.report().splitlines()))
    return launches


# ---------------------------------------------------------------------------
# multi-device: the kernels' range modes, then ranks sharing the card
# ---------------------------------------------------------------------------

N_SHARDS = 4
RANGE_KERNELS = ("ajtai_commit_range", "u1_bterm_range", "cd_sum_range")
RANGE_BIG_KERNELS = ("ajtai_commit_range_bigq", "u1_bterm_range_bigq",
                     "cd_sum_range_bigq")
BATCH_KERNELS = ("ajtai_commit_batch", "u1_bterm_batch", "cd_sum_batch")
BATCH_BIG_KERNELS = ("ajtai_commit_batch_bigq", "u1_bterm_batch_bigq",
                     "cd_sum_batch_bigq")
UNRANGED_KERNELS = COMMITMENT_KERNELS + BIG_KERNELS + BATCH_KERNELS \
    + BATCH_BIG_KERNELS
CONFIG4 = dict(n=128, r=128, kappa=256)   # BASELINE.json config 4, big q
WORLD = 4


def _range_cases(p, seed: int, n: int):
    """(kernel module, label, [(range kernel fn, its plain fn)] a shard,
    compose (the shards' results -> the whole), unranged kernel fn, Work
    of shard 0) of kernels 2-4 at the shapes of ``p``, cut into n shards
    as ``protocol.AxisCtx`` cuts them, on ``_kernel_cases``'s inputs."""
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    from labrador_tpu_torch.protocol import AxisCtx, _stream_shard

    x = _kernel_inputs(p, seed)
    crs, w, t_dig, g_str, h_str = x.crs, x.w, x.t_dig, x.g_str, x.h_str
    per = p.kappa // n

    def cat(parts):
        return torch.cat(parts, 1)

    def summed(parts):
        return sum(parts) % p.q

    def stream_cuts(stream, t_used):
        return [_stream_shard(stream.shape[0] * t_used, AxisCtx(None, n, i))
                for i in range(n)]

    def cd_case(label, stream, off, t_used, base):
        cuts = stream_cuts(stream, t_used)
        shards = [(lambda l0=l0, m=m: cd_cuda.cd_sum(crs, stream, off,
                                                     t_used, base, l0, m),
                   lambda l0=l0, m=m: cd_cuda.cd_sum_plain(crs, stream, off,
                                                           t_used, l0, m))
                  for l0, m in cuts]
        return (cd_cuda, label, shards, summed,
                lambda: cd_cuda.cd_sum(crs, stream, off, t_used, base),
                x.work(p.kappa_2, cuts[0][1], 1, (base or p.b_1) // 2))

    return [
        (ajtai_cuda, "ajtai r_eff=r",
         [(lambda i=i: ajtai_cuda.ajtai_commit(crs, w, i * per, per),
           lambda i=i: ajtai_cuda.ajtai_commit_plain(crs, w, i * per, per))
          for i in range(n)], cat, lambda: ajtai_cuda.ajtai_commit(crs, w),
         x.work(per, p.n, p.r, x.w_max, x.aj_lp)),
        (u1_cuda, "u1 B-term",
         [(lambda i=i: u1_cuda.u1_bterm(crs, t_dig, i * per, per),
           lambda i=i: u1_cuda.u1_bterm_plain(crs, t_dig, i * per, per))
          for i in range(n)], summed, lambda: u1_cuda.u1_bterm(crs, t_dig),
         x.work(p.kappa_1, p.r * p.t_1 * per, 1, p.b_1 // 2)),
        cd_case("cd D-term (u2)", h_str, crs._off_d, p.t_1, 0),
        cd_case("cd C-term (u1)", g_str, crs._off_c, p.t_2, p.b_2),
    ]


def phase_range_modes(stats: dict) -> None:
    """The range modes of kernels 2-4 at the 2^14 shapes, at both moduli,
    cut into N_SHARDS shards: every shard bit-equal to its plain version,
    the shards concatenated (Ajtai) or summed mod q (u1, C/D) equal to
    the unranged kernel; shard 0 timed beside the bound of its own work
    (about the unsharded bound / N_SHARDS).  Records each range mode's
    error, and the times and bound of its first case, in ``stats``."""
    from labrador_tpu_torch.params import LabradorParams
    from labrador_tpu_torch.ops.zq import is_big

    for extra, tag in (({}, "2^14"), (BIG_Q, "2^14 big-q")):
        p = LabradorParams(n=REAL["n"], r=REAL["r"],
                           kappa_override=REAL["kappa"], **extra)
        for mod, label, shards, compose, full, work in _range_cases(
                p, 7, N_SHARDS):
            err, parts = 0, []
            for i, (kern, plain) in enumerate(shards):
                got, want = kern(), plain()
                _sync()
                e = int(torch.max(torch.abs(got - want))) if got.numel() \
                    else 0
                if got.shape != want.shape or e != 0:
                    raise AssertionError(f"{label} range {i}/{N_SHARDS} at "
                                         f"{tag}: kernel != plain ({e})")
                err = max(err, e)
                parts.append(got)
            if not torch.equal(compose(parts), full()):
                raise AssertionError(f"{label} at {tag}: the {N_SHARDS} "
                                     f"shards do not compose to the kernel")
            ms = cuda_ms(shards[0][0], 10)
            plain_ms = cuda_ms(shards[0][1], 1)
            bound_ms, bound_by = work.bound()
            log(f"range {label:16s} {tag:10s} {N_SHARDS} shards bit-equal "
                f"(tolerance 0), composed == unranged; shard 0 "
                f"{tuple(parts[0].shape)} kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  {work.describe()}; at "
                f"{bound_ms / ms:.1%} of the bound")
            info = mod.KERNEL_RANGE_BIG if is_big(p.q) else mod.KERNEL_RANGE
            st = stats.setdefault(info.name, {"max_abs_err": 0})
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if "ms" not in st:
                st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)


# ---------------------------------------------------------------------------
# the reference-parity CRS: MaterializedCRS and the kernels' table modes
# ---------------------------------------------------------------------------

GOLDEN_CHACHA = ROOT / "labrador_tpu_torch" / "golden" / "config1_chacha.json"
TABLE_KERNELS = ("ajtai_commit_table", "u1_bterm_table", "cd_sum_table")
# every commitment kernel that expands the Threefry CRS
THREEFRY_KERNELS = UNRANGED_KERNELS + RANGE_KERNELS + RANGE_BIG_KERNELS
REFSIM_FIELDS = ("t", "g", "u_1", "projection", "b_prime_prime", "h", "u_2",
                 "z")
CHACHA_SEED = bytes(range(32))


def _require_table_only(counts: dict, where: str) -> None:
    """The table modes launched, and no commitment kernel in a Threefry
    mode."""
    _require_launched(counts, TABLE_KERNELS, where)
    threefry = {k: counts[k] for k in THREEFRY_KERNELS if counts[k]}
    if threefry:
        raise AssertionError(f"{where}: Threefry-mode commitment kernels "
                             f"launched on a MaterializedCRS: {threefry}")


def _chacha_config1() -> dict:
    """Config 1 on ``MaterializedCRS.create_chacha``: the table, ``prove``
    and ``prove_fs`` equal golden/config1_chacha.json (digests, sizes,
    f64_reference reports, FS checks); the port's refsim derives the same
    transcript fields and its ref_verify accepts; the table modes launch
    in prove and in verify, no Threefry mode.  Returns the launch counts
    of the prove, verify and FS runs."""
    import hashlib

    from labrador_tpu_torch import (keys, prover, sampling, structs,
                                    verifier)
    from labrador_tpu_torch.crs import MaterializedCRS
    from labrador_tpu_torch.params import LabradorParams
    from labrador_tpu_torch.utils import refsim

    golden = json.loads(GOLDEN_CHACHA.read_text())
    cfg = golden["config"]
    p = LabradorParams(n=cfg["n"], r=cfg["r"])
    crs = MaterializedCRS.create_chacha(p, bytes.fromhex(cfg["base_seed"]),
                                        "cuda")
    table = hashlib.sha256(crs.coeffs.cpu().numpy().astype("<i4")
                           .tobytes()).hexdigest()
    if table != golden["table_sha256"]:
        raise AssertionError(f"config-1 ChaCha table {table} != golden")
    kw, ks, kv = keys.split(keys.key(cfg["key_seed"]), 3)
    witness = sampling.generate_witness(kw, p, "cuda")
    state = structs.generate_state(ks, witness, p)
    f64 = dict(norm_mode="f64_reference")
    counts: dict = {}

    def counted(fn, where: str):
        _reset_counts()
        out = fn()
        _sync()
        _require_table_only(_counts(), where)
        _add_counts(counts, _counts())
        return out

    proof = counted(lambda: prover.prove(p, witness, state, crs, kv),
                    "config-1 ChaCha prove")
    report = counted(lambda: verifier.verify_report(p, state, proof, crs,
                                                    **f64),
                     "config-1 ChaCha verify")
    proof_fs = counted(lambda: prover.prove_fs(p, witness, state, crs),
                       "config-1 ChaCha prove_fs")
    report_fs = counted(lambda: verifier.verify_report(p, state, proof_fs,
                                                       crs, **f64),
                        "config-1 ChaCha verify (FS proof)")
    fs_report = verifier.fs_challenge_report(p, state, proof_fs, crs)
    got = {
        "transcript_sha256": structs.transcript_sha256(proof, p.q),
        "transcript_size_in_bytes": structs.transcript_size_in_bytes(
            proof, p.q),
        "transcript_size_in_bytes_fs": structs.transcript_size_in_bytes(
            proof, p.q, fs=True),
        "verify_report": report}
    got_fs = {
        "transcript_sha256": structs.transcript_sha256(proof_fs, p.q),
        "transcript_size_in_bytes_fs": structs.transcript_size_in_bytes(
            proof_fs, p.q, fs=True),
        "verify_report": report_fs, "fs_challenge_report": fs_report}
    for label, rec, want in (("prove", got, golden["prove"]),
                             ("prove_fs", got_fs, golden["prove_fs"])):
        if rec != want:
            diff = [k for k in want if rec.get(k) != want[k]]
            raise AssertionError(f"config-1 ChaCha {label}: {diff} differ "
                                 f"from the JAX golden record")
    ref = refsim.ref_prove(p, witness, state, crs,
                           refsim.extract_challenges(proof))
    for field in REFSIM_FIELDS:
        if not np.array_equal(getattr(proof, field).cpu().numpy(),
                              ref[field]):
            raise AssertionError(f"config-1 ChaCha: field {field} != "
                                 f"refsim's")
    ref_rep = refsim.ref_verify(p, state, proof, crs)
    if not ref_rep["all"]:
        raise AssertionError(f"refsim rejects the config-1 ChaCha proof: "
                             f"{ref_rep}")
    fs_size = got_fs["transcript_size_in_bytes_fs"]
    log(f"chacha config1: table sha256 == golden; prove sha256 "
        f"{got['transcript_sha256']} size {got['transcript_size_in_bytes']}"
        f" B (fs {got['transcript_size_in_bytes_fs']} B), prove_fs "
        f"{got_fs['transcript_sha256']} (fs {fs_size} B), reports and FS "
        f"checks == JAX golden; refsim fields {', '.join(REFSIM_FIELDS)} "
        f"equal, ref_verify accepts; launches {counts}")
    return counts


def _drawn(plain, crs):
    """plain(crs) on a copy of the MaterializedCRS that records the
    offsets its plain version reads: (result, offsets (rows, L, d))."""
    from labrador_tpu_torch.crs import MaterializedCRS
    drawn = []

    class Recording(MaterializedCRS):
        def draw(self, offsets):
            drawn.append(offsets)
            return super().draw(offsets)

    out = plain(Recording(coeffs=crs.coeffs, key=crs.key, params=crs.params))
    return out, torch.cat(drawn, 1)


def _library_call(table: torch.Tensor, offs: torch.Tensor,
                  dig: torch.Tensor, q: int):
    """The same function as one gather and one float64 product: the tile
    by ``torch.take`` at the offsets, contracted with one ``torch.matmul``
    against the centred digits' negacyclic circulant (every partial sum is
    an integer below 2^53, so exact), then mod q.  The offsets and the
    circulant are made once, outside the call."""
    from labrador_tpu_torch.ops.ring_stream import circulant
    from labrador_tpu_torch.ops.zq import to_signed_small

    rows, L, d = offs.shape
    if int(offs.max()) >= table.numel():
        raise AssertionError("a library tile reads beyond the table")
    idx = offs.reshape(rows, L * d)
    circ = circulant(to_signed_small(dig, q)).reshape(
        dig.shape[0], L * d, d).to(torch.float64)

    def call() -> torch.Tensor:
        tile = torch.take(table, idx).to(torch.float64)
        return torch.remainder(torch.matmul(tile, circ), q).to(torch.int64)

    return call


def _table_cases(p, crs, seed: int):
    """(kernel module, label, kernel fn, plain fn (of a CRS), digits of
    the library call (nrhs, L, d), Work without the table's bytes) of the
    table modes at the shapes of ``p`` on ``_kernel_inputs``'s operands:
    each whole, then shard 0 of N_SHARDS of each range mode."""
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    from labrador_tpu_torch.ops.cd_cuda import _local_digits
    from labrador_tpu_torch.protocol import AxisCtx, _stream_shard

    x = _kernel_inputs(p, seed, crs)
    w, t_dig, g_str, h_str, work = x.w, x.t_dig, x.g_str, x.h_str, x.work
    n_tri = p.r * (p.r + 1) // 2
    per = p.kappa // N_SHARDS
    _, m = _stream_shard(n_tri * p.t_1, AxisCtx(None, N_SHARDS, 0))

    def table_work(wk: Work) -> Work:
        return Work(wk.nbytes, 0, wk.macs, wk.limb_products, wk.mac_ops)

    return [
        (ajtai_cuda, "ajtai r_eff=r",
         lambda c: ajtai_cuda.ajtai_commit(c, w),
         lambda c: ajtai_cuda.ajtai_commit_plain(c, w), w,
         table_work(work(p.kappa, p.n, p.r, x.w_max, x.aj_lp))),
        (u1_cuda, "u1 B-term",
         lambda c: u1_cuda.u1_bterm(c, t_dig),
         lambda c: u1_cuda.u1_bterm_plain(c, t_dig),
         u1_cuda._stream(t_dig, p),
         table_work(work(p.kappa_1, p.r * p.t_1 * p.kappa, 1, p.b_1 // 2))),
        (cd_cuda, "cd D-term (u2)",
         lambda c: cd_cuda.cd_sum(c, h_str, c._off_d, p.t_1),
         lambda c: cd_cuda.cd_sum_plain(c, h_str, c._off_d, p.t_1),
         _local_digits(h_str, 0, None)[None],
         table_work(work(p.kappa_2, n_tri * p.t_1, 1, p.b_1 // 2))),
        (cd_cuda, "cd C-term (u1)",
         lambda c: cd_cuda.cd_sum(c, g_str, c._off_c, p.t_2, p.b_2),
         lambda c: cd_cuda.cd_sum_plain(c, g_str, c._off_c, p.t_2),
         _local_digits(g_str, 0, None)[None],
         table_work(work(p.kappa_2, n_tri * p.t_2, 1, p.b_2 // 2))),
        (ajtai_cuda, f"ajtai rows 0-{per - 1}",
         lambda c: ajtai_cuda.ajtai_commit(c, w, 0, per),
         lambda c: ajtai_cuda.ajtai_commit_plain(c, w, 0, per), w,
         table_work(work(per, p.n, p.r, x.w_max, x.aj_lp))),
        (u1_cuda, f"u1 columns 0-{per - 1}",
         lambda c: u1_cuda.u1_bterm(c, t_dig, 0, per),
         lambda c: u1_cuda.u1_bterm_plain(c, t_dig, 0, per),
         u1_cuda._stream(t_dig, p, 0, per),
         table_work(work(p.kappa_1, p.r * p.t_1 * per, 1, p.b_1 // 2))),
        (cd_cuda, f"cd D-term 0-{m - 1}",
         lambda c: cd_cuda.cd_sum(c, h_str, c._off_d, p.t_1, 0, 0, m),
         lambda c: cd_cuda.cd_sum_plain(c, h_str, c._off_d, p.t_1, 0, m),
         _local_digits(h_str, 0, m)[None],
         table_work(work(p.kappa_2, m, 1, p.b_1 // 2))),
    ]


def hold_table_modes(p, crs, label_size: str, stats: dict | None = None,
                     plain_reps: int = 2) -> None:
    """The table modes against their plain versions (on the same table)
    at the shapes of ``p``, whole and in a range shard; bit-equality
    required, and the library call equal too.  Each case is timed beside
    its bound: tensor-core limb products (``Work``) and the table entries
    it reads (each distinct entry once, 4 bytes, over the memory rate).
    Where ``stats`` is given, records each table mode's error, and the
    times and bound of its whole case."""
    for mod, label, kern, plain, dig, work in _table_cases(p, crs, seed=7):
        got = kern(crs)
        want, offs = _drawn(plain, crs)
        _sync()
        err = int(torch.max(torch.abs(got - want)))
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"table {label} at {label_size}: kernel != "
                                 f"plain (max abs err {err})")
        library = _library_call(crs.coeffs, offs, dig, p.q)
        if not torch.equal(library().reshape(got.shape), got):
            raise AssertionError(f"table {label} at {label_size}: the "
                                 f"library call != the kernel")
        seen = torch.zeros(crs.coeffs.numel(), dtype=torch.bool,
                           device="cuda")
        seen[offs.reshape(-1)] = True
        distinct = int(seen.sum())
        work.nbytes += 4 * distinct
        del seen, offs
        ms = cuda_ms(lambda: kern(crs), 10)
        plain_ms = cuda_ms(lambda: plain(crs), plain_reps)
        library_ms = cuda_ms(library, 3)
        bound_ms, bound_by = work.bound()
        log(f"table {label:18s} {label_size:8s} {str(tuple(got.shape)):15s}"
            f" bit-equal (tolerance 0), library == kernel; kernel {ms:.4f} "
            f"ms  plain {plain_ms:.4f} ms  library {library_ms:.4f} ms  "
            f"{distinct} distinct table entries; {work.describe()}; at "
            f"{bound_ms / ms:.1%} of the bound")
        del library
        if stats is None:
            continue
        st = stats.setdefault(mod.KERNEL_TABLE.name, {"max_abs_err": 0})
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if "ms" not in st:
            st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)


def phase_chacha(stats: dict) -> dict:
    """The reference-parity CRS on the card: config 1 against the JAX
    golden record and refsim (``_chacha_config1``); the table modes
    bit-equal to their plain versions at config 1 and at 2^14 (n = r =
    16, kappa = 256, on its ChaCha table: 26,279,936 coefficients), whole
    and ranged; then 2^14 on the ChaCha CRS end to end, prove and verify,
    every check true, with the table's generation time (host threads,
    then the copy to the card), the peak device memory of the prove and
    verify (the table included) and their ms.  The witness is the
    sampler's, as in ``phase_real``: at q = 8191 it halves a 2^14 witness
    to zero (only the zero witness meets check 14 there), and the
    kernels read every table entry of the commitments all the same.
    Returns the launch counts of the ChaCha prove and verify runs."""
    from labrador_tpu_torch import (keys, prover, sampling, structs,
                                    verifier)
    from labrador_tpu_torch.crs import MaterializedCRS, _used_intervals
    from labrador_tpu_torch.params import LabradorParams

    t0 = time.perf_counter()
    counts = _chacha_config1()
    p1 = LabradorParams(n=2, r=2)
    hold_table_modes(p1, MaterializedCRS.create_chacha(p1, CHACHA_SEED,
                                                       "cuda"), "config1")

    p = LabradorParams(n=REAL["n"], r=REAL["r"], kappa_override=REAL["kappa"])
    _sync()
    t_gen = time.perf_counter()
    crs = MaterializedCRS.create_chacha(p, CHACHA_SEED, "cuda")
    _sync()
    gen_s = time.perf_counter() - t_gen
    hold_table_modes(p, crs, "2^14", stats, plain_reps=1)

    kw, ks, kv = keys.split(keys.key(42), 3)
    witness = sampling.generate_witness(kw, p, "cuda")
    state = structs.generate_state(ks, witness, p)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()     # the table is the baseline
    _reset_counts()
    _sync()
    t1 = time.perf_counter()
    proof = prover.prove(p, witness, state, crs, kv)
    _sync()
    t2 = time.perf_counter()
    report = verifier.verify_report(p, state, proof, crs)
    _sync()
    t3 = time.perf_counter()
    launched = {k: v for k, v in _counts().items() if v}
    _require_table_only(_counts(), "2^14 ChaCha prove + verify")
    _add_counts(counts, _counts())
    if not (bool(proof.jl_ok) and bool(proof.b_pp_ok)) or \
            not all(report.values()):
        failed = [k for k, v in report.items() if not v]
        raise AssertionError(f"2^14 ChaCha prove + verify failed: {failed}")
    size = structs.transcript_size_in_bytes(proof, p.q, fs=True)
    generated = sum(hi - lo for lo, hi in _used_intervals(p))
    log(f"chacha 2^14: {crs.coeffs.numel()} table entries ("
        f"{crs.coeffs.numel() * 4 / 1e9:.3f} GB int32), {generated} ChaCha "
        f"coefficients generated in {gen_s:.2f} s (host threads, then the "
        f"copy to the card); prove {(t2 - t1) * 1e3:.2f} ms, verify "
        f"{(t3 - t2) * 1e3:.2f} ms (first run, host clock after sync), every"
        f" check true, fs size {size} B; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
        f"{launched}")
    log(f"chacha phase: {time.perf_counter() - t0:.2f} s")
    return counts


def _tamper_u1(proof, q: int):
    """u_1[3, 5] + 1 (the tamper of tests/test_sharded.py)."""
    u_1 = proof.u_1.clone()
    u_1[3, 5] = (u_1[3, 5] + 1) % q
    return proof.replace(u_1=u_1)


# the sharded runs: (cell, label, n, r, kappa, big q, oracle, mesh)
SHARDED_RUNS = (
    [("config1", lab, 2, 2, 0, big, orc, (2, 2))
     for lab, big, orc in (("small q", False, "interactive"),
                           ("big q", True, "interactive"),
                           ("--fs", False, "fs"),
                           ("--fs --big-q", True, "fs"))]
    + [("2^14", lab, REAL["n"], REAL["r"], REAL["kappa"], big, orc, (1, 4))
       for lab, big, orc in (("small q", False, "interactive"),
                             ("big q", True, "interactive"),
                             ("--fs", False, "fs"),
                             ("--fs --big-q", True, "fs"))]
    + [("config4", "big q", CONFIG4["n"], CONFIG4["r"], CONFIG4["kappa"],
        True, "interactive", (1, 2))])


def _rank_sharded() -> dict:
    """One rank of the world on the card: every run of SHARDED_RUNS on its
    mesh (ranks beyond a mesh skip its runs), with this rank's launch
    counts from 0 around each sharded prove, the transcripts' digests, the
    prove time, the sharded verifier's reports on the valid and on a
    tampered proof (interactive runs) and, for config 4, the peak device
    memory of the rank; then each mesh's collective costs."""
    import torch.distributed as dist

    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import make_instance, make_params
    from labrador_tpu_torch.parallel.mesh import make_mesh
    from labrador_tpu_torch.parallel.sharded import (make_sharded_prover,
                                                     make_sharded_verifier,
                                                     stack, take)

    meshes = {}
    for run in SHARDED_RUNS:
        if run[-1] not in meshes:
            meshes[run[-1]] = make_mesh(*run[-1], device="cuda")
    out = {"rank": dist.get_rank(), "runs": {}}
    for cell, label, n, r, kappa, big, oracle, shape in SHARDED_RUNS:
        mesh = meshes[shape]
        if not mesh.member:
            continue
        if cell == "config4":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        p = make_params(n, r, kappa, False, big)
        mode = "exact" if big else "reference"
        # instance b of the batch from seed 42 + b: the dp blocks differ
        insts = [make_instance(p, 42 + b, mesh.device)
                 for b in range(mesh.n_dp)]
        st, crs = insts[0][1], insts[0][2]
        fn = make_sharded_prover(p, mesh, mode, oracle)
        _reset_counts()
        ms, tr = _host_ms(lambda: fn(torch.stack([i[0] for i in insts]),
                                     stack([i[1] for i in insts]),
                                     [i[2].key for i in insts],
                                     [i[3] for i in insts]), 1)
        res = {"counts": _counts(), "prove_ms": ms,
               "digests": [structs.transcript_sha256(take(tr, b), p.q)
                           for b in range(mesh.n_dp)]}
        if oracle == "interactive" and cell != "config1":
            vfn = make_sharded_verifier(p, mesh, mode)
            proof = take(tr, 0)
            res["verify_ms"], res["report"] = _host_ms(
                lambda: vfn(st, proof, crs.key), 1)
            res["report_tampered"] = vfn(st, _tamper_u1(proof, p.q),
                                         crs.key)
        if cell == "config4":
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del insts, st, crs, tr
        out["runs"][(cell, label)] = res
    out["collectives"] = {f"{s[0]}x{s[1]}": m.stats.as_dict()
                          for s, m in meshes.items() if m.member}
    return out


def _sharded_references(card_gb: float) -> dict:
    """The single-rank runs of each SHARDED_RUNS cell the ranks must
    equal, one a batch instance (seed 42 + b): at config 1, instance 0's
    golden digest and a prove of instance 1 on one rank here; at 2^14 and
    config 4, a prove on one rank (``prover.prove`` / ``prove_fs``), its
    digest and time, and verify_report on it and on the tampered proof.
    Config 4's single-rank peak memory is measured first and two ranks'
    are reckoned against the card."""
    from labrador_tpu_torch import prover, structs, verifier
    from labrador_tpu_torch.cli import make_instance, make_params

    golden = {"small q": json.loads(GOLDEN.read_text())["transcript_sha256"],
              "big q": json.loads(GOLDEN_BIG.read_text())["base"][
                  "transcript_sha256"]}
    fs = json.loads(GOLDEN_FS.read_text())
    golden["--fs"] = fs["small_q"]["transcript_sha256"]
    golden["--fs --big-q"] = fs["big_q"]["transcript_sha256"]
    refs = {}
    for cell, label, n, r, kappa, big, oracle, (n_dp, _) in SHARDED_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p = make_params(n, r, kappa, False, big)
        mode = "exact" if big else "reference"
        ref = {"digests": []}
        for b in range(n_dp):
            if cell == "config1" and b == 0:
                ref["digests"].append(golden[label])
                continue
            w, st, crs, kv = make_instance(p, 42 + b, "cuda")
            if oracle == "fs":
                ms, proof = _host_ms(lambda: prover.prove_fs(p, w, st, crs,
                                                             mode), 1)
            else:
                ms, proof = _host_ms(lambda: prover.prove(p, w, st, crs, kv,
                                                          mode), 1)
            ref["digests"].append(structs.transcript_sha256(proof, p.q))
            if cell != "config1":
                ref.update(prove_ms=ms,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if oracle == "interactive" and cell != "config1":
                ref["report"] = verifier.verify_report(p, st, proof, crs,
                                                       mode)
                ref["report_tampered"] = verifier.verify_report(
                    p, st, _tamper_u1(proof, p.q), crs, mode)
                if not all(ref["report"].values()):
                    raise AssertionError(f"{cell} {label}: the single-rank "
                                         f"proof does not verify: "
                                         f"{ref['report']}")
            del w, st, proof
        if len(set(ref["digests"])) != n_dp:
            raise AssertionError(f"{cell} {label}: the batch's instances "
                                 f"give equal transcripts")
        refs[(cell, label)] = ref
        if cell == "config4":
            need = 2 * ref["peak_gb"]
            log(f"config4 memory reckoning: single-rank prove peak "
                f"{ref['peak_gb']:.2f} GB; 2 ranks on one card need about "
                f"{need:.2f} GB of the card's {card_gb:.2f} GB (plus a CUDA "
                f"context a process)")
            if need > 0.9 * card_gb:
                raise AssertionError("config4: two ranks do not fit the card")
    torch.cuda.empty_cache()
    return refs


def _check_rank_run(key, res: dict, ref: dict, rank: int) -> None:
    cell, label = key
    where = f"{cell} {label} rank {rank}"
    if res["digests"] != ref["digests"]:
        raise AssertionError(f"{where}: sharded transcripts {res['digests']} "
                             f"!= single-rank {ref['digests']}")
    big = "big" in label or cell == "config4"
    want = RANGE_BIG_KERNELS if big else RANGE_KERNELS
    _require_launched(res["counts"], want, where)
    unranged = [k for k in UNRANGED_KERNELS if res["counts"][k]]
    other = [k for k in (RANGE_KERNELS if big else RANGE_BIG_KERNELS)
             if res["counts"][k]]
    if unranged or other:
        raise AssertionError(f"{where}: kernels {unranged + other} launched "
                             f"outside the range mode of the run's modulus")
    if "report" in res:
        if res["report"] != ref["report"] or not res["report"]["all"]:
            raise AssertionError(f"{where}: sharded report {res['report']} "
                                 f"!= single-rank {ref['report']}")
        bad = res["report_tampered"]
        if bad != ref["report_tampered"] or bad["c19_u1"] or bad["all"] \
                or not bad["c20_u2"]:
            raise AssertionError(f"{where}: tampered u_1 report {bad} (single"
                                 f"-rank {ref['report_tampered']})")


def phase_sharded(card: str) -> dict:
    """Ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    device): a world of WORLD spawned processes runs SHARDED_RUNS, config
    1 on a dp 2 x rows 2 mesh (a batch of two instances) against the JAX
    golden digest and a single-rank run, 2^14 on dp 1 x rows 4 and config 4
    on dp 1 x rows 2 against single-rank runs on the card; every rank's counts show the range modes of the run's modulus,
    and no other commitment kernel.  Shows that the range modes and the
    collectives are exact on the card at full width, nothing of scaling.
    Returns the range modes' launches in the 2^14 runs, summed over the
    ranks, for the kernels line."""
    from labrador_tpu_torch.ops import cuda_lib
    from labrador_tpu_torch.parallel.multihost import spawn_local

    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    refs = _sharded_references(card_gb)
    cuda_lib.load()              # built: the ranks load it, none rebuilds
    t0 = time.perf_counter()
    ranks = spawn_local(_rank_sharded, WORLD, threads=2,
                        timeout_s=900)
    world_s = time.perf_counter() - t0
    launches: dict = {}
    for out in ranks:
        for key, res in out["runs"].items():
            _check_rank_run(key, res, refs[key], out["rank"])
            if key[0] == "2^14":
                _add_counts(launches, {k: v for k, v in res["counts"].items()
                                       if k in RANGE_KERNELS
                                       + RANGE_BIG_KERNELS})
    for cell, label, *_, shape in SHARDED_RUNS:
        key = (cell, label)
        per = [o["runs"][key] for o in ranks if key in o["runs"]]
        ref = refs[key]
        ms = ", ".join(f"{r['prove_ms']:.2f}" for r in per)
        want = ("JAX golden, single-rank" if cell == "config1"
                else "single-rank")
        digests = ", ".join(d[:16] + ".." for d in ref["digests"])
        line = (f"sharded {cell} {label} (dp {shape[0]} x rows {shape[1]}, "
                f"ranks share one card over gloo): transcripts == {want} "
                f"{digests}; prove ms by rank {ms} (first run, host clock "
                f"after sync)")
        if "prove_ms" in ref:
            line += f"; single-rank prove {ref['prove_ms']:.2f} ms"
        if "report" in per[0]:
            line += (f"; sharded verify {per[0]['verify_ms']:.2f} ms, report "
                     f"== single-rank, tampered u_1 fails c19 alone")
        if "peak_gb" in per[0]:
            peaks = ", ".join(f"{r['peak_gb']:.2f}" for r in per)
            line += (f"; peak device memory by rank {peaks} GB "
                     f"(single-rank {ref['peak_gb']:.2f} GB)")
        launched = {k: v for k, v in per[0]["counts"].items() if v}
        log(line + f"; launches rank 0 {launched}")
    for out in ranks:
        log(f"sharded collectives rank {out['rank']}: "
            f"{json.dumps(out['collectives'])}")
    log(f"sharded: world of {WORLD} ranks on {card}: {world_s:.2f} s "
        f"(process start, CUDA init and every run); range-mode launches in "
        f"the 2^14 runs {launches}")
    return launches


# ---------------------------------------------------------------------------
# batched proving: the kernels' batch modes, prove_batch, the port's bench
# ---------------------------------------------------------------------------

BATCH_SHAPES = (("config1", dict(n=2, r=2), 3),
                ("2^14", dict(n=REAL["n"], r=REAL["r"],
                              kappa_override=REAL["kappa"]), 4))
BATCH_REAL = 8                          # the 2^14 --big-q batch
BATCH_BENCH = 16                        # bench.py's batch, at config 1


def _batch_cases(p, B: int, seed: int):
    """(kernel module, label, batch fn, plain fn, B single launches fn,
    Work of the batch) of kernels 2-4's batch modes at the shapes of ``p``:
    B instances of ``_kernel_inputs`` (seeds seed .. seed + B - 1, each its
    own CRS), whole and as shard 0 of N_SHARDS (every instance the same
    range, as vmap inside shard_map)."""
    from labrador_tpu_torch.crs import CRSBatch
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    from labrador_tpu_torch.protocol import AxisCtx, _stream_shard

    xs = [_kernel_inputs(p, seed + b) for b in range(B)]
    crs = CRSBatch.stack([x.crs for x in xs], device="cuda")
    w = torch.stack([x.w for x in xs])
    t_dig = torch.stack([x.t_dig for x in xs])
    g_str = torch.stack([x.g_str for x in xs])
    h_str = torch.stack([x.h_str for x in xs])
    x0, per = xs[0], p.kappa // N_SHARDS

    def times_b(work: Work) -> Work:
        return Work(work.nbytes * B, work.int32_ops * B, work.macs * B,
                    work.limb_products, work.mac_ops)

    cases = []
    for tag, rng_ in (("", None), (f" shard 0/{N_SHARDS}", (0, per))):
        row = () if rng_ is None else rng_
        cases.append((ajtai_cuda, "ajtai r_eff=r" + tag,
                      lambda row=row: ajtai_cuda.ajtai_commit(crs, w, *row),
                      lambda row=row: ajtai_cuda.ajtai_commit_plain(crs, w,
                                                                    *row),
                      lambda row=row: [ajtai_cuda.ajtai_commit(
                          x.crs, x.w, *row) for x in xs],
                      times_b(x0.work(per if row else p.kappa, p.n, p.r,
                                      x0.w_max, x0.aj_lp))))
        cases.append((u1_cuda, "u1 B-term" + tag,
                      lambda row=row: u1_cuda.u1_bterm(crs, t_dig, *row),
                      lambda row=row: u1_cuda.u1_bterm_plain(crs, t_dig,
                                                             *row),
                      lambda row=row: [u1_cuda.u1_bterm(x.crs, x.t_dig,
                                                        *row) for x in xs],
                      times_b(x0.work(p.kappa_1, p.r * p.t_1 * (
                          per if row else p.kappa), 1, p.b_1 // 2))))
        for label, stream, off, t_used, base in (
                ("cd D-term (u2)", h_str, crs._off_d, p.t_1, 0),
                ("cd C-term (u1)", g_str, crs._off_c, p.t_2, p.b_2)):
            L = stream.shape[1] * t_used
            cut = () if rng_ is None else _stream_shard(
                L, AxisCtx(None, N_SHARDS, 0))
            cases.append((
                cd_cuda, label + tag,
                lambda st=stream, o=off, t=t_used, b=base, c=cut:
                    cd_cuda.cd_sum(crs, st, o, t, b, *c),
                lambda st=stream, o=off, t=t_used, c=cut:
                    cd_cuda.cd_sum_plain(crs, st, o, t, *c),
                lambda st=stream, o=off, t=t_used, b=base, c=cut: [
                    cd_cuda.cd_sum(x.crs, st[i], o, t, b, *c)
                    for i, x in enumerate(xs)],
                times_b(x0.work(p.kappa_2, cut[1] if cut else L, 1,
                                (base or p.b_1) // 2))))
    return cases


def hold_batch_modes(stats: dict) -> None:
    """Each batch mode of kernels 2-4 bit-equal to its plain version and
    to B single launches, at config 1 (B = 3) and 2^14 (B = 4), both
    moduli, whole and shard 0 of N_SHARDS; timed by CUDA events beside the
    B single launches, its bound (the single instance's Work times B) and
    its plain version.  Records each batch mode's error, and the times of
    its first whole case at 2^14, in ``stats``."""
    from labrador_tpu_torch.ops.zq import is_big
    from labrador_tpu_torch.params import LabradorParams

    for extra, qtag in (({}, ""), (BIG_Q, " big-q")):
        for size, shape, B in BATCH_SHAPES:
            p = LabradorParams(**shape, **extra)
            for mod, label, kern, plain, singles, work in _batch_cases(
                    p, B, 11):
                got, want, one = kern(), plain(), singles()
                _sync()
                err = int(torch.max(torch.abs(got - want))) \
                    if got.numel() else 0
                if got.shape != want.shape or err != 0:
                    raise AssertionError(f"batch {label} at {size}{qtag} B="
                                         f"{B}: kernel != plain ({err})")
                if not torch.equal(got, torch.stack(one)):
                    raise AssertionError(f"batch {label} at {size}{qtag}: "
                                         f"!= {B} single launches")
                ms = cuda_ms(kern, 10)
                singles_ms = cuda_ms(singles, 10)
                plain_ms = cuda_ms(plain, 1)
                bound_ms, bound_by = work.bound()
                log(f"batch {label:26s} {size}{qtag:6s} B={B} "
                    f"{str(tuple(got.shape)):18s} bit-equal (tolerance 0) "
                    f"to plain and to {B} single launches; batch {ms:.4f} "
                    f"ms, {B} single launches {singles_ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms; {work.describe()}; at "
                    f"{bound_ms / ms:.1%} of the bound")
                if "shard" in label:
                    continue
                info = mod.KERNEL_BATCH_BIG if is_big(p.q) \
                    else mod.KERNEL_BATCH
                st = stats.setdefault(info.name, {"max_abs_err": 0})
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if size == "2^14" and "ms" not in st:
                    # no single PyTorch call expands B Threefry CRSs and
                    # contracts them: library_ms stays null
                    st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None)


def _batch_run(p, seeds, mode: str, oracle: str, where: str) -> dict:
    """``prover.prove_batch`` of the CLI's instances at ``seeds`` on the
    card, its launch counts from 0, every instance equal field by field to
    its single-instance prove (whose counts, from 0, the batch's must
    equal: one launch a call site, not one an instance), and
    ``verify_report_batch`` all true with the same counts as one
    single-instance verify.  Returns the counts, times and peak memory."""
    from labrador_tpu_torch import prover, structs, verifier
    from labrador_tpu_torch.cli import make_instance
    from labrador_tpu_torch.crs import CRSBatch

    insts = [make_instance(p, s, "cuda") for s in seeds]
    B = len(insts)
    w = torch.stack([i[0] for i in insts])
    st = structs.stack([i[1] for i in insts])
    crs_b = CRSBatch.stack([i[2] for i in insts], device="cuda")
    vkeys = [i[3] for i in insts]
    prover.prove_batch(p, w[:1], structs.take(st, slice(0, 1)), crs_b[0:1],
                       vkeys[:1], oracle, mode)            # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    batch_ms, tr = _host_ms(lambda: prover.prove_batch(
        p, w, st, crs_b, vkeys, oracle, mode), 1)
    in_prove = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _reset_counts()
    verify_ms, rep = _host_ms(lambda: verifier.verify_report_batch(
        p, st, tr, crs_b, mode), 1)
    in_verify = _counts()
    bad = [k for k, v in rep.items() if not bool(v.all())]
    if bad:
        raise AssertionError(f"{where}: verify_report_batch fails {bad}")

    def single(i):
        w1, st1, crs1, kv = insts[i]
        if oracle == "fs":
            return prover.prove_fs(p, w1, st1, crs1, mode)
        return prover.prove(p, w1, st1, crs1, kv, mode)

    single_ms = []
    for i in range(B):
        _reset_counts()
        ms, one = _host_ms(lambda: single(i), 1)
        one_counts = _counts()
        single_ms.append(ms)
        got = structs.take(tr, i)
        diff = [f for f in one.__dataclass_fields__
                if not torch.equal(getattr(got, f), getattr(one, f))]
        if diff:
            raise AssertionError(f"{where}: instance {i} differs from its "
                                 f"single prove in {diff}")
    _reset_counts()
    verifier.verify_report(p, insts[0][1], structs.take(tr, 0), insts[0][2],
                           mode)
    one_verify = _counts()
    big = p.q > 32513
    names = (BATCH_BIG_KERNELS, BIG_KERNELS) if big \
        else (BATCH_KERNELS, COMMITMENT_KERNELS)
    for counts, ref, what in ((in_prove, one_counts, "prove"),
                              (in_verify, one_verify, "verify")):
        _require_launched(counts, names[0], f"{where} {what}")
        want = [ref[k] for k in names[1]]
        if [counts[k] for k in names[0]] != want or any(
                counts[k] for k in names[1]):
            raise AssertionError(f"{where} {what}: batch launches "
                                 f"{counts} != one single-instance "
                                 f"{what}'s {ref}")
    return dict(B=B, batch_ms=batch_ms, verify_ms=verify_ms,
                single_ms=single_ms, peak_gb=peak_gb, in_prove=in_prove,
                in_verify=in_verify, tr=tr)


def phase_batch(stats: dict) -> dict:
    """Batched proving on the card.  The batch modes of kernels 2-4 held
    (``hold_batch_modes``); ``prove_batch`` of BATCH_REAL 2^14 ``--big-q``
    instances (n = r = 16, kappa = 256, q = 4294967311: the realistic
    witness) and of BATCH_BENCH config-1 instances with both oracles
    (instance 0, seed 42, = the JAX golden digest), each instance = its
    single prove, ``verify_report_batch`` all true, the launches of
    kernels 2-4 those of one single-instance prove and verify; then the
    port's bench, ``python -m labrador_tpu_torch.bench --batch-prove 16
    --batch-verify 16 --verify-profile --phases``, whose JSON line is
    printed.  Returns the batch modes' launches in the 2^14 --big-q and the
    config-1 batches, for the kernels line."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import make_params

    hold_batch_modes(stats)
    launches: dict = {}
    p = make_params(REAL["n"], REAL["r"], REAL["kappa"], False, True)
    run = _batch_run(p, range(42, 42 + BATCH_REAL), "exact", "interactive",
                     "2^14 --big-q batch")
    _add_counts(launches, {k: v for k, v in run["in_prove"].items()
                           if k in BATCH_BIG_KERNELS})
    _add_counts(launches, {k: v for k, v in run["in_verify"].items()
                           if k in BATCH_BIG_KERNELS})
    B = run["B"]
    log(f"batch 2^14 --big-q (n={p.n}, r={p.r}, kappa={p.kappa}, q={p.q}) "
        f"B={B}: every "
        f"instance == its single prove, verify_report_batch all true; "
        f"prove_batch {run['batch_ms']:.2f} ms = "
        f"{B / run['batch_ms'] * 1e3:.2f} proofs/s against {B} single "
        f"proves {sum(run['single_ms']):.2f} ms = "
        f"{B / sum(run['single_ms']) * 1e3:.2f} proofs/s (first runs, host "
        f"clock after sync); verify_report_batch {run['verify_ms']:.2f} ms; "
        f"peak device memory of the batch prove {run['peak_gb']:.3f} GB; "
        f"launches prove {_launched(run['in_prove'])}, verify "
        f"{_launched(run['in_verify'])} (= one single-instance prove's and "
        f"verify's)")
    golden = {"interactive": json.loads(GOLDEN.read_text())[
        "transcript_sha256"], "fs": json.loads(GOLDEN_FS.read_text())[
            "small_q"]["transcript_sha256"]}
    p1 = make_params(2, 2)
    for oracle in ("interactive", "fs"):
        where = f"config1 batch ({oracle})"
        run = _batch_run(p1, range(42, 42 + BATCH_BENCH), "reference",
                         oracle, where)
        digest = structs.transcript_sha256(structs.take(run["tr"], 0), p1.q)
        if digest != golden[oracle]:
            raise AssertionError(f"{where}: instance 0 digest {digest} != "
                                 f"JAX golden {golden[oracle]}")
        _add_counts(launches, {k: v for k, v in run["in_prove"].items()
                               if k in BATCH_KERNELS})
        _add_counts(launches, {k: v for k, v in run["in_verify"].items()
                               if k in BATCH_KERNELS})
        log(f"batch config1 ({oracle}) B={run['B']}: instance 0 == JAX "
            f"golden, every instance == its single prove, "
            f"verify_report_batch all true; prove_batch "
            f"{run['batch_ms']:.2f} ms = "
            f"{run['B'] / run['batch_ms'] * 1e3:.2f} proofs/s against "
            f"{sum(run['single_ms']):.2f} ms of single proves; launches "
            f"prove {_launched(run['in_prove'])}")
    log(f"batch: batch-mode launches {launches}")
    phase_bench()
    return launches


def _launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def phase_bench() -> None:
    """The port's bench on the card, in its own process; its stdout's one
    JSON line is printed here, its stderr's lines after it."""
    cmd = [sys.executable, "-m", "labrador_tpu_torch.bench",
           "--batch-prove", str(BATCH_BENCH), "--batch-verify",
           str(BATCH_BENCH), "--verify-profile", "--phases"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} stdout lines")
    line = json.loads(lines[0])
    if sorted(line) != ["metric", "unit", "value", "vs_baseline"] \
            or not line["value"] > 0:
        raise AssertionError(f"bench line {line}")
    log(json.dumps(line))
    for err_line in proc.stderr.strip().splitlines():
        log(f"bench: {err_line}")
    log(f"bench: {time.perf_counter() - t0:.2f} s in its own process")


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    stats = phase_kernels()
    phase_range_modes(stats)
    stats["negacyclic_polymul"] = phase_polymul()
    phase_jl_projection()
    phase_config1()
    phase_real()
    phase_recursion_config1()
    launches = phase_recursion_real(stats)
    phase_bigq_config1()
    phase_bigq_real()
    phase_bigq_recursion_config1()
    _add_counts(launches, {k: v for k, v in
                           phase_bigq_recursion_real(stats).items()
                           if k in BIG_RECURSION_KERNELS})
    stats["sha_stream"] = phase_sha_stream()
    phase_fs_config1()
    _add_counts(launches, phase_fs_real(big_q=False))
    _add_counts(launches, phase_fs_real(big_q=True))
    _add_counts(launches, phase_phases_real())
    _add_counts(launches, phase_chacha(stats))
    _add_counts(launches, phase_sharded(card))
    _add_counts(launches, phase_batch(stats))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.2f} s "
        f"on {card}, the kernels' build included")
    rows = []
    for k in _kernels():
        st = stats[k.name]
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                     "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                     "bound_by": st["bound_by"],
                     "library_ms": st["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

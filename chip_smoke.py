"""Smoke run of the PyTorch + CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version (kernels 2-4 in their small-q
and their big-q mode), proves and verifies config 1 against the JAX
package's golden transcript, proves and verifies the 2^14-coefficient
instance (BASELINE.json config 3), runs the recursion flow (``cli -R``:
prove, fold, prove and verify the folded instance) at config 1 against the
JAX golden digests and at the 2^14 base, and does the same at the
2^32-scale modulus (``cli --big-q``, with and without ``-R``).  Also runs
the JL projection on a witness of 8,388,608 coefficients, above the
4,194,303 where the port's projection used to stop, exact on the rows it
checks against numpy.

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py

Every phase raises on failure, so the script exits non-zero; without a
CUDA device it exits non-zero before printing any result.  The line before
the last lists each kernel with its launches in the 2^14 recursion run of
its modulus, its time beside the plain version's, a library call's and its
bound; the last line of standard output is the result JSON.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "config1.json"
GOLDEN_R = ROOT / "labrador_tpu_torch" / "golden" / "config1_recursion.json"
GOLDEN_BIG = ROOT / "labrador_tpu_torch" / "golden" / "config1_bigq.json"
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


def _kernel_cases(p, seed: int):
    """(kernel module, label, kernel fn, plain fn, Work) at the shapes of
    instance ``p``, on inputs from a fixed numpy seed.  Small q: random
    residues for Ajtai, random centred digits lifted mod q for the u1
    B-term and the C/D sums.  Big q, the JAX package's convention there:
    signed operands at their magnitude bounds, an Ajtai witness up to q/2
    (the most the kernel takes, beyond the JAX package's int32 witness),
    -2^31 among them (it reaches check 15 as the int32 wrap of an
    oversized z), and digits up to +-b/2, the bounds present."""
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, ntt, u1_cuda
    from labrador_tpu_torch.ops.zq import is_big
    from labrador_tpu_torch.protocol import _tri_stream

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
    n_tri = p.r * (p.r + 1) // 2
    aj_lp = ajtai_cuda.entry_limbs(p.q) * ajtai_cuda.witness_limbs(p.q)
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
    import importlib.util

    from labrador_tpu_torch.ops import ntt

    spec = importlib.util.spec_from_file_location(
        "coef_kernel_tests", ROOT / "tests" / "test_torch_coef_kernel.py")
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
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
    """Every kernel of the port, each mode of kernels 2-4 apart."""
    from labrador_tpu_torch.ops import (ajtai_cuda, cd_cuda, polymul_cuda,
                                        u1_cuda)
    return [polymul_cuda.KERNEL, ajtai_cuda.KERNEL, u1_cuda.KERNEL,
            cd_cuda.KERNEL, ajtai_cuda.KERNEL_BIG, u1_cuda.KERNEL_BIG,
            cd_cuda.KERNEL_BIG]


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
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
                   recursion=True)
    launches = _counts()
    _require_launched(launches, ALL_KERNELS, "config-1 -R")
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
    from labrador_tpu_torch import recursion, structs
    from labrador_tpu_torch.cli import run_flow
    from labrador_tpu_torch.ops import ntt

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda", recursion=True)
    launches = _counts()
    _require_launched(launches, ALL_KERNELS, "2^14 -R")
    _check_folded(res, "2^14 -R")
    f = res.folded
    p, p2 = res.params, f.params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sizes = (structs.transcript_size_in_bytes(res.proof, p.q),
             structs.transcript_size_in_bytes(res.proof, p.q, fs=True),
             structs.transcript_size_in_bytes(f.proof, p2.q, fs=True))
    log(f"2^14 -R: all checks true; folded n'={p2.n} r'={p2.r} "
        f"k'={p2.k_count} beta'={p2.beta_override}; launches {launches}")
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

    # the base-CRS streams of one phi_alpha_modq, timed alone
    st = f.state
    p0 = st.layout.params
    plan = ntt.plan_for(p0)
    rng = np.random.default_rng(3)
    alpha = _t(rng.integers(0, p0.q, (p2.k_count, p0.d)))
    aA, aB, aC = st._alpha_split(alpha)[:3]
    steps = (
        ("phi_alpha_modq", lambda: st.phi_alpha_modq(alpha)),
        ("_alpha_contract_a", lambda: recursion._alpha_contract_a(
            st.base_crs, ntt.ntt_fwd(aA, plan), p0, plan)),
        ("_alpha_contract_b", lambda: recursion._alpha_contract_b(
            st.base_crs, ntt.ntt_fwd(aB, plan), p0, plan)),
        ("_alpha_contract_cd C+D", lambda: (
            recursion._alpha_contract_cd(st.base_crs, st.base_crs._off_c,
                                         ntt.ntt_fwd(aB, plan), p0.t_2, p0,
                                         plan),
            recursion._alpha_contract_cd(st.base_crs, st.base_crs._off_d,
                                         ntt.ntt_fwd(aC, plan), p0.t_1, p0,
                                         plan))),
    )
    parts = []
    for name, fn in steps:
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        parts.append(f"{name} {(time.perf_counter() - t0) * 1e3:.2f} ms")
    log(f"2^14 -R streams (host clock after sync): {', '.join(parts)}")
    _profile_folded_prove(res)
    return launches


def _require_big_only(counts: dict, where: str) -> None:
    """A big-q run launches the big-q kernels, and no small-q one."""
    _require_launched(counts, BIG_KERNELS, where)
    small = [n for n in ALL_KERNELS if counts[n]]
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
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda",
                   recursion=True, big_q=True)
    launches = _counts()
    _require_big_only(launches, "config-1 --big-q -R")
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
    record of the TPU rounds.  Returns the launches of the run, the kernels
    line's counts of the big-q kernels."""
    from labrador_tpu_torch import keys, prover, recursion, structs, verifier
    from labrador_tpu_torch.cli import FOLDED_CRS_XOR, run_flow
    from labrador_tpu_torch.crs import CRS

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda", recursion=True,
                   big_q=True)
    launches = _counts()
    _require_big_only(launches, "2^14 --big-q -R")
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
        f"{launches}")
    log(f"2^14 --big-q -R: prove {res.prove_s * 1e3:.2f} ms, verify "
        f"{res.verify_s * 1e3:.2f} ms, fold {f.fold_s * 1e3:.2f} ms, folded "
        f"prove {f.prove_s * 1e3:.2f} ms, folded verify "
        f"{f.verify_s * 1e3:.2f} ms (host clock after sync); peak device "
        f"memory {peak_gb:.2f} GB")
    log(f"2^14 --big-q -R: fs size base {sizes[0]} B -> folded {sizes[1]} B")
    _profile_folded_prove(res, "2^14 --big-q -R")
    hold_kernels(p2, "2^14 -R' big-q", stats, plain_reps=1)

    # the fold of the TPU rounds' size record (PERF.md): mu = 16 witness
    # vectors for the digit stream instead of the CLI's round(sqrt(.))
    t0 = time.perf_counter()
    p3, w3, s3, _ = recursion.fold(p, res.state, res.proof, res.crs, mu=16)
    crs3 = CRS.create(p3, seed=42 ^ FOLDED_CRS_XOR)
    proof3 = prover.prove(p3, w3, s3, crs3, keys.fold_in(res.verifier_key, 1),
                          decomp_mode="exact")
    rep3 = verifier.verify_report(p3, s3, proof3, crs3, decomp_mode="exact")
    _sync()
    if not all(rep3.values()):
        raise AssertionError(f"2^14 --big-q -R mu=16 failed: {rep3}")
    log(f"2^14 --big-q -R mu=16: folded n'={p3.n} r'={p3.r}, all checks "
        f"true; fs size {sizes[0]} B -> "
        f"{structs.transcript_size_in_bytes(proof3, p3.q, fs=True)} B "
        f"(fold + prove + verify {(time.perf_counter() - t0) * 1e3:.2f} ms)")
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
             "prove_phase3", "sample_challenge", "sample_jl_matrix",
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


def main() -> int:
    phase_device()
    phase_build()
    stats = phase_kernels()
    stats["negacyclic_polymul"] = phase_polymul()
    phase_jl_projection()
    phase_config1()
    phase_real()
    phase_recursion_config1()
    launches = phase_recursion_real(stats)
    phase_bigq_config1()
    phase_bigq_real()
    phase_bigq_recursion_config1()
    launches.update({k: v for k, v in phase_bigq_recursion_real(stats).items()
                     if k in BIG_KERNELS})
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

"""Where the time of kernel 1 goes, on one CUDA card.

Builds ``labrador_tpu_torch/csrc/polymul.cu`` apart (nvcc, into a
temporary directory) once as it is and once for each part stubbed out,
and times each build by CUDA events over 50 launches of the C entry point
(no wrapper).  The stubs change what the kernel computes, so only the
first build is checked against the plain version.

The bhat variant (default) at ``bench.py``'s serving shape (65,536
products against one transformed operand, q = 8191):

* ``no_garner``: no Garner pass and no store of the result;
* ``no_mma``: the tensor-core products replaced by one integer operation
  each on the fragments;
* ``no_epilogue``: the weight sums reduced by a mask, not by Barrett steps;
* ``no_read``: no load of the operand rows (zeros).

The coefficient variant (``--coef``) at BASELINE.json config 2 (10^5
products, q = 8191):

* ``no_reduce``: the input reduction replaced by a mask of the low bits;
* ``no_copy``: every ``cp.async`` zero-fills its 16 bytes of shared
  memory and reads nothing;
* ``no_loop``: no multiply-adds (the sums stay 0);
* ``no_store``: no store of the result.

Usage, from the root of a checkout on a machine with one CUDA card:
    python3 bhat_parts.py [--coef]
Prints the card's name and power limit, then one line per build with the
kernel's ptxas registers.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from labrador_tpu_torch.ops import cuda_lib, ntt, polymul_cuda
from labrador_tpu_torch.params import LabradorParams

ROWS = 65_536
COEF_ROWS = 100_000
REPS = 50
SOURCE = cuda_lib.CSRC / "polymul.cu"
MMA_ASM = (
    'asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "\n'
    '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, '
    '%3};\\n"\n'
    '      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])\n'
    '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), '
    '"r"(b.y));')
# build name -> (text of the source, its replacement)
STUBS = {
    "as is": [],
    "no_garner": [("const int nrows = static_cast<int>(",
                   "const int nrows = 0 * static_cast<int>(")],
    "no_mma": [(MMA_ASM, "c[0] += a[0] ^ b.x; c[1] += a[1]; "
                         "c[2] += a[2] ^ b.y; c[3] += a[3];")],
    "no_epilogue": [("  const uint32_t w = barrett32_lazy(\n",
                     "  return (s[0][nt][c] ^ s[1][nt][c] ^ s[2][nt][c]) "
                     "& 0x3FFF;\n  const uint32_t w = barrett32_lazy(\n")],
    "no_read": [("av[rr] = row < n ?", "av[rr] = false ?")],
}
# the coefficient variant's stubs; each condition holds on every call, but
# the compiler cannot know it and keeps the code that depends on it
COEF_STUBS = {
    "as is": [],
    "no_reduce": [("int32_t coef_centred(int64_t x, const CoefArgs& g) {\n",
                   "int32_t coef_centred(int64_t x, const CoefArgs& g) {\n"
                   "  if (g.q > 0) return static_cast<int32_t>(x) & 0xFFF;\n")],
    "no_copy": [("    const bool valid = row < g.n;\n",
                 "    const bool valid = row < g.n && g.q == 0;\n")],
    "no_loop": [("      for (int r = 0; r < 8; ++r) acc[r] += av[s] * buf[8 - s + r];",
                 "      for (int r = 0; r < 8; ++r) acc[r] = g.q > 0 ? 0 : "
                 "acc[r] + av[s] * buf[8 - s + r];")],
    "no_store": [("      if (row < g.n)\n        *reinterpret_cast<longlong2*>",
                  "      if (row < g.n && (v.x ^ v.y) > 0xFFFFu)\n"
                  "        *reinterpret_cast<longlong2*>")],
}


def build(name: str, subs, out_dir: Path, entry: str,
          symbol: str) -> tuple[ctypes.CDLL, str]:
    """polymul.cu with subs applied, built into out_dir; the library with
    ``entry``'s argument types, and ptxas's registers line for the kernel
    whose mangled name holds ``symbol``."""
    src = SOURCE.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the stub's text is not in {SOURCE}")
        src = src.replace(old, new)
    cu = out_dir / f"{name.replace(' ', '_')}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    start = next((i for i, line in enumerate(lines) if symbol in line),
                 len(lines))
    regs = [line.strip() for line in lines[start:] if "registers" in line]
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = list(cuda_lib._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return lib, regs[0] if regs else ""


def bhat_setup(plan, rng, stream):
    """(stubs, entry, kernel symbol, launch(lib), check()) of the bhat
    variant at the serving shape."""
    a = torch.from_numpy(rng.integers(0, plan.q, (ROWS, 64))).cuda()
    bhat = ntt.ntt_fwd(torch.from_numpy(
        rng.integers(0, plan.q, (1, 64))).cuda(), plan)
    tables, consts = polymul_cuda._kernel_tables(plan, a.device)
    out = torch.empty_like(a)

    def launch(lib):
        cuda_lib.check(lib.polymul_bhat_launch(
            a.data_ptr(), bhat.data_ptr(), tables.data_ptr(),
            consts.data_ptr(), out.data_ptr(), ROWS, 64, 0, 64,
            plan.n_primes, stream))

    return (STUBS, "polymul_bhat_launch", "polymul_bhat_kernelILi3", launch,
            lambda: torch.equal(out, polymul_cuda.negacyclic_polymul_bhat_plain(
                a, bhat, plan)))


def coef_setup(plan, rng, stream):
    """The same for the coefficient variant at config 2."""
    a = torch.from_numpy(rng.integers(0, plan.q, (COEF_ROWS, 64))).cuda()
    b = torch.from_numpy(rng.integers(0, plan.q, (COEF_ROWS, 64))).cuda()
    out = torch.empty_like(a)
    flush, shift, m32, m64 = polymul_cuda.coef_consts(plan.q)

    def launch(lib):
        cuda_lib.check(lib.polymul_coef_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), COEF_ROWS, COEF_ROWS,
            0, 64, 0, 64, plan.q, flush, shift, m32, m64, stream))

    return (COEF_STUBS, "polymul_coef_launch",
            f"polymul_coef_kernelILi{flush}", launch,
            lambda: torch.equal(out, polymul_cuda.negacyclic_polymul_plain(
                a, b, plan)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coef", action="store_true",
                    help="the coefficient variant at config 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bhat_parts.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    plan = ntt.plan_for(LabradorParams(n=2, r=2))
    rng = np.random.default_rng(2)
    stream = torch.cuda.current_stream().cuda_stream
    stubs, entry, symbol, launch, check = (coef_setup if args.coef
                                           else bhat_setup)(plan, rng, stream)
    with tempfile.TemporaryDirectory() as tmp:
        for name, subs in stubs.items():
            lib, regs = build(name, subs, Path(tmp), entry, symbol)
            launch(lib)
            torch.cuda.synchronize()
            if not subs and not check():
                raise AssertionError("the kernel disagrees with its plain "
                                     "version")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                launch(lib)
            stop.record()
            torch.cuda.synchronize()
            print(f"{name:12s} {start.elapsed_time(stop) / REPS:.4f} ms  "
                  f"({regs})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of kernel 1's bhat variant goes, on one CUDA card.

Builds ``labrador_tpu_torch/csrc/polymul.cu`` apart (nvcc, into a
temporary directory) once as it is and once for each part stubbed out,
and times each build at ``bench.py``'s serving shape (65,536 products
against one transformed operand, q = 8191) by CUDA events over 50 launches
of the C entry point (no wrapper).  The stubs change what the kernel
computes, so only the first build is checked against the plain version:

* ``no_garner``: no Garner pass and no store of the result;
* ``no_mma``: the tensor-core products replaced by one integer operation
  each on the fragments;
* ``no_epilogue``: the weight sums reduced by a mask, not by Barrett steps;
* ``no_read``: no load of the operand rows (zeros).

Usage, from the root of a checkout on a machine with one CUDA card:
    python3 bhat_parts.py
Prints the card's name and power limit, then one line per build.  Imports
nothing of JAX.
"""

from __future__ import annotations

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


def build(name: str, subs, out_dir: Path) -> tuple[ctypes.CDLL, str]:
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
    start = next((i for i, line in enumerate(lines)
                  if "polymul_bhat_kernelILi3" in line), len(lines))
    regs = [line.strip() for line in lines[start:] if "registers" in line]
    lib = ctypes.CDLL(str(so))
    lib.polymul_bhat_launch.argtypes = list(
        cuda_lib._SIGNATURES["polymul_bhat_launch"])
    lib.polymul_bhat_launch.restype = ctypes.c_int
    return lib, regs[0] if regs else ""


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bhat_parts.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    plan = ntt.plan_for(LabradorParams(n=2, r=2))
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, plan.q, (ROWS, 64))).cuda()
    bhat = ntt.ntt_fwd(torch.from_numpy(
        rng.integers(0, plan.q, (1, 64))).cuda(), plan)
    tables, consts = polymul_cuda._kernel_tables(plan, a.device)
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        for name, subs in STUBS.items():
            lib, regs = build(name, subs, Path(tmp))

            def call():
                cuda_lib.check(lib.polymul_bhat_launch(
                    a.data_ptr(), bhat.data_ptr(), tables.data_ptr(),
                    consts.data_ptr(), out.data_ptr(), ROWS, 64, 0, 64,
                    plan.n_primes, stream))

            call()
            torch.cuda.synchronize()
            if not subs and not torch.equal(
                    out, polymul_cuda.negacyclic_polymul_bhat_plain(
                        a, bhat, plan)):
                raise AssertionError("the kernel disagrees with its plain "
                                     "version")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                call()
            stop.record()
            torch.cuda.synchronize()
            print(f"{name:12s} {start.elapsed_time(stop) / REPS:.4f} ms  "
                  f"({regs})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times the kernels of the checkout in the current directory on one CUDA
card, beside their bounds: the commitment kernels (Ajtai, the u1 B-term,
the C/D sums) and kernel 1 (the ring product, both variants).

Usage, from the root of a checkout (it imports that checkout's
``chip_smoke.py`` and package, so two commits are compared in one run on
one card by running it from the root of each, in turns):
    python3 <path to>/kernel_times.py [--reps N]

Shapes: the 2^14 instance (n = r = 16, kappa = 256) at q = 8191 and at
q = 4294967311, and the instances its ``-R`` fold gives at those moduli
(n' = 175, r' = 180, beta' = 1; n' = 132, r' = 135, beta' = 957114; k' =
771, kappa' = 16), on chip_smoke.py's random inputs.  Each time is the
mean of ``--reps`` wrapper calls after one warm-up, by CUDA events; the
second ("launch") is the same with the wrappers' operand checks
(``check_digit_range``, ``check_big_operand``, ``raise_if_flagged``: a
device sync each) replaced by no-ops, the kernels' own time and their
launches.  Kernel 1 at the shapes of
``polymul_cases`` in this script's own ``chip_smoke.py`` (config 2, the
fixed-operand serving shape, per-row bhat, the -R ring products), run on
the checkout's package, with its two yardsticks (a float64 grouped conv1d,
a float64 matmul against b's negacyclic matrix) and a calibration of the
memory rate for config 2's bytes (one torch.add of two int64 (10^5, 64)
tensors into a third: the same reads and writes).  Prints one line per
kernel and shape, the card's name and power limit, and a last line of
JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402  (the checkout's, from the cwd)
from labrador_tpu_torch.ops import (ajtai_cuda, cd_cuda,  # noqa: E402
                                    u1_cuda)
from labrador_tpu_torch.params import LabradorParams  # noqa: E402

# the operand checks of the wrappers of either commit, by module
CHECKS = {mod: [n for n in ("check_digit_range", "check_big_operand",
                            "raise_if_flagged") if hasattr(mod, n)]
          for mod in (ajtai_cuda, cd_cuda, u1_cuda)}


def launch_ms(kern, reps: int) -> float:
    """cs.cuda_ms with the wrappers' operand checks replaced by no-ops."""
    saved = {(m, n): getattr(m, n) for m, names in CHECKS.items()
             for n in names}
    for m, n in saved:
        setattr(m, n, lambda *a, **k: None)
    try:
        return cs.cuda_ms(kern, reps)
    finally:
        for (m, n), f in saved.items():
            setattr(m, n, f)

BIG_Q = dict(q_start=(1 << 32) - 1, exact_digits=True)
FOLD = dict(k_count=771, l_count=1, kappa_override=16, exact_digits=True)
SHAPES = {
    "2^14": lambda: LabradorParams(n=16, r=16, kappa_override=256),
    "2^14 big-q": lambda: LabradorParams(n=16, r=16, kappa_override=256,
                                         **BIG_Q),
    "2^14 -R'": lambda: LabradorParams(n=175, r=180, q=8191, beta_override=1,
                                       **FOLD),
    "2^14 -R' big-q": lambda: LabradorParams(n=132, r=135, q=4294967311,
                                             beta_override=957114, **FOLD),
}


def _own_chip_smoke():
    """The chip_smoke.py beside this script (the checkout's may predate
    ``polymul_cases``); its functions import the package from the cwd."""
    spec = importlib.util.spec_from_file_location(
        "kernel_times_chip_smoke", Path(__file__).resolve().parent /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def polymul_rows(reps: int) -> list[dict]:
    cases, yard = _own_chip_smoke().polymul_cases()
    rows = []
    for label, count, kern, plain, work in cases:
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"polymul {label}: kernel != plain")
        ms = cs.cuda_ms(kern, reps)
        bound_ms, bound_by = work.bound()
        rows.append({"shape": label, "kernel": "polymul", "ms": ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"polymul {label:40s} {ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by}), at {bound_ms / ms:.1%} of it", flush=True)
    for name, (call, check) in yard.items():
        if not check():
            raise AssertionError(f"the {name} yardstick disagrees")
        ms = cs.cuda_ms(call, reps)
        rows.append({"shape": f"yardstick {name}", "kernel": "library",
                     "ms": ms})
        print(f"polymul yardstick {name:30s} {ms:.4f} ms", flush=True)
    # what the card's memory delivers for config 2's traffic: two int64
    # (10^5, 64) tensors read, one written, by one elementwise add
    x = torch.zeros((cs.POLY_PRODUCTS, 64), dtype=torch.int64, device="cuda")
    y, o = torch.ones_like(x), torch.empty_like(x)
    ms = cs.cuda_ms(lambda: torch.add(x, y, out=o), reps)
    rows.append({"shape": "same bytes as config 2: torch.add",
                 "kernel": "calibration", "ms": ms})
    print(f"polymul same bytes as config 2 (torch.add)   {ms:.4f} ms = "
          f"{3 * x.numel() * 8 / ms / 1e9:.3f} TB/s", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    card = cs.phase_device()
    rows = []
    for shape, make in SHAPES.items():
        for _, label, kern, _, work in cs._kernel_cases(make(), seed=7):
            ms = cs.cuda_ms(kern, args.reps)
            lms = launch_ms(kern, args.reps)
            bound_ms, bound_by = work.bound()
            rows.append({"shape": shape, "kernel": label, "ms": ms,
                         "launch_ms": lms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"{shape:15s} {label:16s} {ms:.4f} ms (launch {lms:.4f} "
                  f"ms)  bound {bound_ms:.4f} ms ({bound_by}), at "
                  f"{bound_ms / lms:.1%} of it", flush=True)
    rows += polymul_rows(args.reps)
    print(json.dumps({"card": card, "checkout": os.getcwd(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times the commitment kernels (Ajtai, the u1 B-term, the C/D sums) of the
checkout in the current directory on one CUDA card, beside their bounds.

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
launches.  Prints one
line per kernel and shape, the card's name and power limit, and a last
line of JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    print(json.dumps({"card": card, "checkout": os.getcwd(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

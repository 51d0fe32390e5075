"""Runs the port's CLI flow stage by stage on one CUDA card and prints each
stage's time and the peak device memory as it goes, so that a run which
stops shows where.  Stages: witness, CRS and state; prove; verify; and
with ``-R`` fold, folded residual, folded prove, folded verify.

Usage, from the root of a checkout (BASELINE.json config 5, the 2^20
big-q base with recursion):
    python3 stage_times.py --n 128 --r 128 --kappa 256 --big-q -R

Prints the card's name and power limit first.  Times are host clock after
``torch.cuda.synchronize()``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from labrador_tpu_torch import keys, prover, recursion, sampling, structs
from labrador_tpu_torch import verifier
from labrador_tpu_torch.cli import (CRS_SEED_MULT, FOLDED_CRS_XOR,
                                    make_params)
from labrador_tpu_torch.crs import CRS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--kappa", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--big-q", action="store_true")
    ap.add_argument("-R", "--recursion", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t_last = time.perf_counter()

    def stage(name: str, **info) -> None:
        nonlocal t_last
        torch.cuda.synchronize()
        now = time.perf_counter()
        extra = "".join(f", {k} {v}" for k, v in info.items())
        print(f"{name}: {(now - t_last) * 1e3:.2f} ms, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB{extra}",
              flush=True)
        t_last = time.perf_counter()

    p = make_params(args.n, args.r, args.kappa, args.recursion, args.big_q)
    mode = "exact" if (args.recursion or args.big_q) else "reference"
    print(f"params: n={p.n} r={p.r} kappa={p.kappa} q={p.q} t1={p.t_1}/"
          f"b1={p.b_1} t2={p.t_2}/b2={p.b_2}", flush=True)
    kw, ks, kv = keys.split(keys.key(args.seed), 3)
    witness = sampling.generate_witness(kw, p, "cuda")
    crs = CRS.create(p, seed=args.seed * CRS_SEED_MULT % 2**64)
    state = structs.generate_state(ks, witness, p)
    stage("witness, CRS and state")
    proof = prover.prove(p, witness, state, crs, kv, mode)
    stage("prove", jl_ok=bool(proof.jl_ok), b_pp_ok=bool(proof.b_pp_ok))
    report = verifier.verify_report(p, state, proof, crs, mode)
    stage("verify", all=report["all"])
    if not args.recursion:
        return 0 if report["all"] else 1
    p2, w2, s2, _ = recursion.fold(p, state, proof, crs)
    stage("fold", folded=f"n'={p2.n} r'={p2.r} k'={p2.k_count} "
          f"kappa'={p2.kappa} ({p2.r * p2.n * p2.d} coefficients)")
    residual = recursion.folded_residual(s2, w2, p2)
    stage("folded residual", residual=residual)
    crs2 = CRS.create(p2, seed=args.seed ^ FOLDED_CRS_XOR)
    proof2 = prover.prove(p2, w2, s2, crs2, keys.fold_in(kv, 1), "exact")
    stage("folded prove", jl_ok=bool(proof2.jl_ok),
          b_pp_ok=bool(proof2.b_pp_ok))
    report2 = verifier.verify_report(p2, s2, proof2, crs2, "exact")
    stage("folded verify", all=report2["all"])
    size = structs.transcript_size_in_bytes(proof2, p2.q, fs=True)
    print(f"folded fs size {size} B", flush=True)
    return 0 if report["all"] and residual == 0 and report2["all"] else 1


if __name__ == "__main__":
    sys.exit(main())

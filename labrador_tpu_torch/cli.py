"""Demo CLI: end-to-end prove + verify on PyTorch, the flow of
``labrador_tpu/cli.py`` (the reference's ``main.rs:44-116``).

Usage:
    python -m labrador_tpu_torch.cli [--verbose] [--device {cuda,cpu}]
                                     [--n N] [--r R] [--kappa K] [--seed S]

``--device cuda`` (the default) runs the commitments on the CUDA kernels
and fails if no card is present; ``--device cpu`` runs their plain PyTorch
versions.  Same seeds give the same transcript as the JAX package.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from . import keys, prover, sampling, structs, verifier
from .crs import CRS
from .params import LabradorParams

# the JAX CLI's CRS seed derivation from --seed
CRS_SEED_MULT = 0x9E3779B97F4A7C15

_NOT_PORTED = {
    "fs": "Fiat-Shamir mode (--fs) belongs to the FS slice",
    "big_q": "--big-q belongs to the big-q slice",
    "recursion": "recursion (-R) belongs to the recursion slice",
    "phases": "--phases belongs to the checkpoint slice",
    "ckpt": "--ckpt belongs to the checkpoint slice",
}


@dataclass
class FlowResult:
    params: LabradorParams
    witness: torch.Tensor
    state: structs.State
    crs: CRS
    proof: structs.Transcript
    report: dict
    prove_s: float
    verify_s: float


def print_constants(p: LabradorParams) -> None:
    """Mirror of ``print_constants`` (main.rs:10-24)."""
    print("Printing runtime-computed constants:")
    for name, val in (("Q", p.q), ("BETA", p.beta_bound), ("STD", p.std),
                      ("B", p.b), ("B_1", p.b_1), ("B_2", p.b_2),
                      ("T_1", p.t_1), ("T_2", p.t_2), ("GAMMA", p.gamma),
                      ("GAMMA_1", p.gamma_1), ("GAMMA_2", p.gamma_2),
                      ("BETA_PRIME", p.beta_prime),
                      ("CRT primes", p.crt_primes)):
        print(f"{name}: {val}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_flow(n: int = 2, r: int = 2, kappa: int = 0, seed: int = 42,
             device="cuda", verbose: bool = False) -> FlowResult:
    """Witness, CRS, state, prove, verify_report — the CLI's flow."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    if verbose:
        print("Welcome to the LaBRADOR Proof System (PyTorch + CUDA port)!")
        print("=====================================\n")
        print_constants(p)
        print(f"commitment kernels: {prover.resolve_backend(device)}")
        print("Generating Witness Matrix")
    kw, ks, kv = keys.split(keys.key(seed), 3)
    witness = sampling.generate_witness(kw, p, device)
    crs = CRS.create(p, seed=seed * CRS_SEED_MULT % 2**64)
    state = structs.generate_state(ks, witness, p)
    if verbose:
        print("Generating proof..")
    _sync(device)
    t0 = time.perf_counter()
    proof = prover.prove(p, witness, state, crs, kv)
    _sync(device)
    t1 = time.perf_counter()
    report = verifier.verify_report(p, state, proof, crs)
    _sync(device)
    t2 = time.perf_counter()
    return FlowResult(p, witness, state, crs, proof, report, t1 - t0, t2 - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="LaBRADOR proof system on PyTorch + CUDA (demo flow)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=2, help="witness rank n")
    ap.add_argument("--r", type=int, default=2, help="witness count r")
    ap.add_argument("--kappa", type=int, default=0,
                    help="override the commitment rank (0 = reference n*d)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--fs", action="store_true")
    ap.add_argument("--big-q", action="store_true")
    ap.add_argument("-R", "--recursion", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--ckpt", type=str, default="")
    args = ap.parse_args(argv)
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"not yet ported: {why}")

    res = run_flow(args.n, args.r, args.kappa, args.seed, args.device,
                   args.verbose)
    proof, p = res.proof, res.params
    if not bool(proof.jl_ok):
        print("Error: JL projection failed after max retries")
        return 1
    if not bool(proof.b_pp_ok):
        print("Error: b'' constant-term self-check failed")
        return 1
    if not res.report["all"]:
        failed = [k for k, v in res.report.items() if not v]
        print(f"Error: Proof Verification Failed: {failed}")
        return 1
    if args.verbose:
        print("Success: Proof Verified!")
        print("=========================")
        size = structs.transcript_size_in_bytes(proof, p.q)
        print(f"Size of proof: {size / 1024:.2f} KB")
        print(f"prove: {res.prove_s:.3f}s  verify: {res.verify_s:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

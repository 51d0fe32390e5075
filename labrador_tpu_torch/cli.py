"""Demo CLI: end-to-end prove + verify on PyTorch, the flow of
``labrador_tpu/cli.py`` (the reference's ``main.rs:44-116``).

Usage:
    python -m labrador_tpu_torch.cli [--verbose] [--device {cuda,cpu}]
                                     [--n N] [--r R] [--kappa K] [--seed S]
                                     [--big-q] [-R] [--mu MU] [--fs]
                                     [--phases] [--ckpt PATH]

``--device cuda`` (the default) runs the kernels and fails if no card is
present; ``--device cpu`` runs their plain PyTorch versions.  ``--big-q``
takes the 2^32-scale modulus q = 4294967311 (``q_start = 2^32 - 1``) with
exact digits, as the JAX CLI does.  ``-R`` proves with exact digits, then
folds the proof into a recursive instance and proves it
(``prover.prove_recursive``, at ``--mu`` digit-stream vectors, 0 for
round(sqrt(garbage))) and checks the recursive proof without the base
opening (``verifier.verify_recursive``); ``-R --mu 16 --big-q --n 16
--r 16 --kappa 256`` is the benchmark's fold configuration.  ``--fs``
proves non-interactively (Fiat-Shamir) and verifies with ``verify_fs``;
with ``-R`` the folded instance is then proved interactively, as in the
JAX CLI.  ``--phases`` proves one phase at a time and prints each phase's
time with ``--verbose``; ``--ckpt PATH`` also saves each phase to PATH and
resumes from it.  ``--fs`` takes precedence over both.  Same seeds give the same transcripts as the JAX
package.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from . import keys, prover, recursion, sampling, structs, verifier
from .crs import CRS
from .params import LabradorParams
# the JAX CLI's CRS seeds (``recursion.folded_crs``): FOLDED_CRS_XOR is
# named here too, where the tests and stage_times.py read both
from .recursion import CRS_SEED_MULT, FOLDED_CRS_XOR  # noqa: F401
from .utils.profiling import PhaseTimer
# --big-q: the modulus search start of the reference's commented
# 2^32-scale configuration (constants.rs:196), q = 4294967311
BIG_Q_START = (1 << 32) - 1

@dataclass
class FoldResult:
    """The recursive proof of ``-R`` with ``verify_recursive``'s report,
    the fold it was made of (the folded params, digit witness, state and
    CRS), the prover's residual of the folded relation, and the step
    times.  ``proof`` and ``report`` are the folded transcript and its
    ``verify_report``."""

    params: LabradorParams
    witness: torch.Tensor
    state: recursion.FoldedState
    crs: CRS
    residual: int
    fold_s: float
    prove_s: float
    verify_s: float
    recursive: structs.RecursiveProof
    recursive_report: dict

    @property
    def proof(self) -> structs.Transcript:
        return self.recursive.folded

    @property
    def report(self) -> dict:
        return {k.split(".", 1)[1]: v
                for k, v in self.recursive_report.items()
                if k.startswith("folded.")}


@dataclass
class FlowResult:
    params: LabradorParams
    witness: torch.Tensor
    state: structs.State
    crs: CRS
    proof: structs.Transcript
    report: dict
    ok: bool
    prove_s: float
    verify_s: float
    verifier_key: keys.Key
    timer: PhaseTimer | None = None
    folded: FoldResult | None = None


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


def make_params(n: int, r: int, kappa: int = 0, recursion: bool = False,
                big_q: bool = False) -> LabradorParams:
    """The JAX CLI's parameters: exact digits with -R or --big-q."""
    return LabradorParams(n=n, r=r, kappa_override=kappa,
                          exact_digits=recursion or big_q,
                          **({"q_start": BIG_Q_START} if big_q else {}))


def make_instance(p: LabradorParams, seed: int, device="cuda"):
    """The CLI's instance of ``p`` from ``seed``, as the JAX CLI makes it:
    (witness, state, CRS, verifier key)."""
    kw, ks, kv = keys.split(keys.key(seed), 3)
    witness = sampling.generate_witness(kw, p, device)
    crs = CRS.create(p, seed=seed * CRS_SEED_MULT % 2**64)
    state = structs.generate_state(ks, witness, p)
    return witness, state, crs, kv


def run_flow(n: int = 2, r: int = 2, kappa: int = 0, seed: int = 42,
             device="cuda", verbose: bool = False,
             recursion: bool = False, big_q: bool = False, fs: bool = False,
             phases: bool = False, ckpt: str = "", mu: int = 0) -> FlowResult:
    """Witness, CRS, state, prove, verify_report — the CLI's flow; with
    ``recursion`` (exact digits) also ``fold_flow`` on the proof at
    ``mu``; with ``big_q`` at the 2^32-scale modulus.  ``fs``: ``prove_fs``, and the
    report adds ``fs_challenge_report``'s checks (the verdict is
    ``verify_fs``'s); else ``phases`` or ``ckpt``: ``prove_checkpointed``
    with a PhaseTimer (and checkpoint path ``ckpt``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    p = make_params(n, r, kappa, recursion, big_q)
    decomp_mode = "exact" if (recursion or big_q) else "reference"
    if verbose:
        print("Welcome to the LaBRADOR Proof System (PyTorch + CUDA port)!")
        print("=====================================\n")
        print_constants(p)
        print(f"commitment kernels: {prover.resolve_backend(device)}")
        print("Generating Witness Matrix")
    witness, state, crs, kv = make_instance(p, seed, device)
    if verbose:
        print("Generating proof..")
    timer = None
    _sync(device)
    t0 = time.perf_counter()
    if fs:
        proof = prover.prove_fs(p, witness, state, crs, decomp_mode)
    elif phases or ckpt:
        timer = PhaseTimer(device)
        proof = prover.prove_checkpointed(p, witness, state, crs, kv,
                                          ckpt or None, decomp_mode, timer)
    else:
        proof = prover.prove(p, witness, state, crs, kv, decomp_mode)
    _sync(device)
    t1 = time.perf_counter()
    report = verifier.verify_report(p, state, proof, crs, decomp_mode)
    if fs:
        report.update(verifier.fs_challenge_report(p, state, proof, crs))
        ok = report["all_with_bpp"] and report["fs_all"]
    else:
        ok = report["all"]
    _sync(device)
    t2 = time.perf_counter()
    res = FlowResult(p, witness, state, crs, proof, report, ok, t1 - t0,
                     t2 - t1, kv, timer)
    if recursion and ok:
        res.folded = fold_flow(res, mu)
    return res


def fold_flow(base: FlowResult, mu: int = 0) -> FoldResult:
    """``-R`` of the JAX CLI: ``recursion.fold`` of the base proof, the
    prover's check of the folded relation on its digit witness, then
    ``prover.prove_recursive`` on that fold (the folded instance proved on
    ``recursion.folded_crs``, the JAX CLI's seed ^ FOLDED_CRS_XOR, with
    the verifier key fold_in(kv, 1)) and ``verifier.verify_recursive`` of
    the recursive proof."""
    device = base.witness.device
    p, state, crs = base.params, base.state, base.crs
    timer = PhaseTimer(device)
    with timer.phase("fold"):
        fold = recursion.fold(p, state, base.proof, crs, mu)
    p2, w2, s2, _ = fold
    residual = recursion.folded_residual(s2, w2, p2)
    rproof = prover.prove_recursive(p, base.witness, state, crs,
                                    base.verifier_key, mu, timer=timer,
                                    base=base.proof, fold=fold)
    rreport = verifier.verify_recursive(p, state, rproof, crs, mu,
                                        timer=timer)
    ph = timer.phases
    verify_s = sum(ph[k] for k in ("base_public", "fold_statement",
                                   "folded_verify") if k in ph)
    return FoldResult(p2, w2, s2, recursion.folded_crs(crs, p2), residual,
                      ph["fold"], ph["folded_prove"], verify_s, rproof,
                      rreport)


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
    ap.add_argument("--fs", action="store_true",
                    help="non-interactive (Fiat-Shamir) mode")
    ap.add_argument("--big-q", action="store_true",
                    help="2^32-scale modulus q = 4294967311, exact digits")
    ap.add_argument("-R", "--recursion", action="store_true",
                    help="fold the proof into a recursive instance and "
                         "prove+verify that too")
    ap.add_argument("--mu", type=int, default=0,
                    help="-R: digit-stream vectors of the folded witness "
                         "(0 = round(sqrt(garbage)))")
    ap.add_argument("--phases", action="store_true",
                    help="prove one phase at a time, with a per-phase "
                         "timer report")
    ap.add_argument("--ckpt", type=str, default="",
                    help="checkpoint path: save each proving phase and "
                         "resume from the last one saved (implies "
                         "--phases)")
    args = ap.parse_args(argv)

    res = run_flow(args.n, args.r, args.kappa, args.seed, args.device,
                   args.verbose, args.recursion, args.big_q, args.fs,
                   args.phases, args.ckpt, args.mu)
    proof, p = res.proof, res.params
    if res.timer is not None and args.verbose:
        print("Per-phase prover timings:")
        print(res.timer.report())
    if not bool(proof.jl_ok):
        print("Error: JL projection failed after max retries")
        return 1
    if not bool(proof.b_pp_ok):
        print("Error: b'' constant-term self-check failed")
        return 1
    if not res.ok:
        failed = [k for k, v in res.report.items() if not v]
        print(f"Error: Proof Verification Failed: {failed}")
        return 1
    if args.verbose:
        print("Success: Proof Verified!")
        print("=========================")
        size = structs.transcript_size_in_bytes(proof, p.q)
        print(f"Size of proof: {size / 1024:.2f} KB ({size} B)")
        if args.fs:
            size = structs.transcript_size_in_bytes(proof, p.q, fs=True)
            print(f"Size of the non-interactive proof: {size / 1024:.2f} "
                  f"KB ({size} B)")
        print(f"prove: {res.prove_s:.3f}s  verify: {res.verify_s:.3f}s")
    if args.recursion:
        return _report_folded(res, args.verbose)
    return 0


def _report_folded(res: FlowResult, verbose: bool) -> int:
    f = res.folded
    if f.residual != 0:
        print("Error: folded relation does not hold")
        return 1
    if not (bool(f.proof.jl_ok) and bool(f.proof.b_pp_ok)):
        print("Error: folded prover self-checks failed")
        return 1
    if not f.recursive_report["all"]:
        failed = [k for k, v in f.recursive_report.items() if not v]
        print(f"Error: recursive proof failed verification: {failed}")
        return 1
    if verbose:
        print("Folding proof into a recursive instance (structured)..")
        p, p2 = res.params, f.params
        size = structs.transcript_size_in_bytes(res.proof, p.q)
        size2 = structs.transcript_size_in_bytes(f.proof, p2.q)
        print(f"Recursive instance: n'={p2.n} r'={p2.r} k'={p2.k_count} "
              f"kappa'={p2.kappa} (folded in {f.fold_s + f.prove_s + f.verify_s:.2f}s)")
        print(f"Proof size: base {size / 1024:.2f} KB -> folded "
              f"{size2 / 1024:.2f} KB")
        print("Success: recursive proof verified!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

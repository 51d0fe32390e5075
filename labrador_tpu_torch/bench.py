"""The port's benchmark entry point, the counterpart of the repository's
``bench.py``.  Prints ONE JSON line on stdout:

  {"metric": "rq_ntt_polymul_ops_per_s", "value": N, "unit": "ops/s",
   "vs_baseline": N}

and everything else on stderr, first the card's name and power limit.
Run from the repository root:

    python -m labrador_tpu_torch.bench                  # on the card
    python -m labrador_tpu_torch.bench --cpu --quick    # plain versions

The headline is the throughput of kernel 1's ``_bhat`` variant
(``ops/polymul_cuda.negacyclic_polymul_bhat``): products of (batch, 64)
polynomials against their forward-transformed partners, the transform
taken once outside the timed loop (``bench.py``'s hoisted-operand path).
``vs_baseline`` is its ratio to the frozen CPU number of the JAX package
in ``bench_baseline.json`` (read only), the yardstick ``bench.py`` uses.
``--cpu`` runs the plain PyTorch versions on the CPU; without it the card
is required, with no fallback to the CPU.  Each function keeps the name
and defaults of its counterpart in ``bench.py`` (``kappa``, where added, is
the CLI's override: 0 keeps the parameters' own); ``--calibrate`` (which
would rewrite ``bench_baseline.json``) and ``--pallas`` / ``--no-pallas``
(the card always runs the kernel) are not ported.  Times are host clocks
around work that ends in a device sync: PyTorch runs eagerly, so there is
no compile to exclude, only a warm-up call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import keys, prover, sampling, structs, verifier
from .crs import CRS, CRSBatch
from .params import LabradorParams

BASELINE = Path(__file__).resolve().parent.parent / "bench_baseline.json"

# The roofline guard of the headline (``bench.py`` refuses a rate above
# its chip's peak).  Against this card's own bound, counted as
# ``chip_smoke.Work`` counts a ``_bhat`` call: each input read once and
# the output written once, 8 bytes a coefficient, over the H100's
# 3.35 TB/s: the (batch, 64) operand, the (P, batch, 64) transformed one
# and the (batch, 64) product.  A rate above it is not device-bound (a
# clock that missed the device's work), so it is refused, not printed.
HBM_BYTES_PER_S = 3.35e12

# the clock of every timing here (a test stops it to check the guard)
_clock = time.perf_counter


def _stderr(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device) -> float:
    """Seconds of fn(), from a device sync before it to one after it."""
    _sync(device)
    t0 = _clock()
    fn()
    _sync(device)
    return _clock() - t0


def bhat_bound_s(batch: int, n_primes: int, d: int = 64) -> float:
    """The least time of one ``_bhat`` call on the card: its bytes over
    the memory rate (above)."""
    return 8 * d * (2 * batch + n_primes * batch) / HBM_BYTES_PER_S


def bench_polymul(batch: int = 65_536, scan_len: int = 1024,
                  iters: int = 4, device="cuda") -> float:
    """Rq polymul products/s: ``iters`` passes of ``scan_len`` steps, each
    step one ``_bhat`` call on (batch, 64) residues against the (P, batch,
    64) transform of a second operand, hoisted out of the loop; the median
    pass.  Every step multiplies a different input (the previous product
    XOR-folded into the operand and reduced mod q, as ``bench.py``), and
    each pass ends in a device sync and fetches a checksum of the carry.
    The rate is refused when a step took less than the card's bound for
    the call (``bhat_bound_s``)."""
    from .ops import ntt
    from .ops.modmath import mod_pos
    from .ops.polymul_cuda import negacyclic_polymul_bhat

    dev = torch.device(device)
    p = LabradorParams(n=2, r=2)
    plan = ntt.plan_for(p)

    def run(key) -> float:
        ka, kb = keys.split(key)
        a = sampling.uniform_zq(ka, (batch, p.d), p.q, dev)
        b = sampling.uniform_zq(kb, (batch, p.d), p.q, dev)
        bhat = ntt.ntt_fwd(b, plan)                # loop-invariant: once
        carry = torch.zeros((batch, p.d), dtype=torch.int64, device=dev)

        def scan():
            nonlocal carry
            for _ in range(scan_len):
                out = negacyclic_polymul_bhat(mod_pos(a ^ carry, p.q), bhat,
                                              plan)
                carry = carry ^ out
            int(torch.sum(carry))                  # fetched: a checksum

        return _timed(scan, dev)

    run(keys.key(999))                             # warm-up
    rates = []
    for i in range(iters):
        rates.append(batch * scan_len / run(keys.key(i)))
    _stderr(f"polymul passes ({batch}x{scan_len} products a pass): "
            + ", ".join(f"{r:,.0f}" for r in rates) + " ops/s")
    if max(rates) > 1.25 * min(rates):
        _stderr("WARNING: polymul passes vary >25% — treat with suspicion")
    med = statistics.median(rates)
    ceiling = batch / bhat_bound_s(batch, plan.n_primes)
    if med > ceiling:
        raise RuntimeError(
            f"measured {med:,.0f} products/s is above the card's bound of "
            f"{ceiling:,.0f} products/s for the call's bytes; the timing "
            f"is not device-bound, refusing to report it")
    return med


def _instance(p: LabradorParams, seed: int, crs_seed: int, device):
    """(witness, state, CRS, verifier key) of ``bench.py``'s instances:
    three keys split from ``keys.key(seed)``."""
    kw, ks, kv = keys.split(keys.key(seed), 3)
    witness = sampling.generate_witness(kw, p, device)
    state = structs.generate_state(ks, witness, p)
    return witness, state, CRS.create(p, seed=crs_seed), kv


def bench_e2e(n: int = 2, r: int = 2, iters: int = 8, device="cuda",
              kappa: int = 0) -> dict:
    """Prove and verify seconds and the proof size in KiB: the median of
    ``iters`` proves over distinct verifier keys and of verifying 4
    distinct proofs, each call between device syncs, after a first prove
    and verify that must pass."""
    dev = torch.device(device)
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    witness, state, crs, kv = _instance(p, 7, 0x1234_5678_9ABC_DEF0, dev)
    proof = prover.prove(p, witness, state, crs, kv)
    if not verifier.verify_report(p, state, proof, crs)["all"]:
        raise AssertionError("bench proof failed verification")
    t_prove = statistics.median(
        _timed(lambda i=i: prover.prove(p, witness, state, crs,
                                        keys.fold_in(kv, i)), dev)
        for i in range(iters))
    proofs = [prover.prove(p, witness, state, crs, keys.fold_in(kv, i))
              for i in range(4)]
    t_verify = statistics.median(
        _timed(lambda pf=pf: verifier.verify_report(p, state, pf, crs), dev)
        for pf in proofs)
    size = structs.transcript_size_in_bytes(proof, p.q)
    return {"prove_s": t_prove, "verify_s": t_verify,
            "proof_kb": size / 1024.0}


def _batch(p: LabradorParams, batch: int, seed: int, crs_seed: int, dev):
    """``bench.py``'s batch: every instance its own witness, state and CRS
    seed (crs_seed + i) and verifier key, from keys.key(seed)."""
    ks = keys.split(keys.key(seed), batch * 3)
    insts = []
    for i in range(batch):
        w = sampling.generate_witness(ks[3 * i], p, dev)
        insts.append((w, structs.generate_state(ks[3 * i + 1], w, p)))
    crs_b = CRSBatch.create(p, [crs_seed + i for i in range(batch)], dev)
    return (torch.stack([w for w, _ in insts]),
            structs.stack([st for _, st in insts]), crs_b,
            [ks[3 * i + 2] for i in range(batch)])


def bench_batch_prove(batch: int = 16, n: int = 2, r: int = 2,
                      iters: int = 5, device="cuda",
                      kappa: int = 0) -> float:
    """Proofs/s of ``prover.prove_batch`` over a batch of independent
    instances (distinct witnesses, states and CRS seeds): ``iters``
    batches with distinct verifier keys after a warm-up batch."""
    dev = torch.device(device)
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    wit, state_b, crs_b, vkeys = _batch(p, batch, 3, 1000, dev)
    prover.prove_batch(p, wit, state_b, crs_b, vkeys)     # warm-up

    def run():
        for i in range(iters):
            prover.prove_batch(p, wit, state_b, crs_b,
                               [keys.fold_in(k, i) for k in vkeys])

    return batch * iters / _timed(run, dev)


def bench_batch_verify(batch: int = 16, n: int = 2, r: int = 2,
                       iters: int = 5, device="cuda",
                       kappa: int = 0) -> float:
    """Proofs verified per second by ``verifier.verify_report_batch``:
    ``iters`` distinct batches of proofs of independent instances, the
    first of which must verify, after a warm-up."""
    dev = torch.device(device)
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    wit, state_b, crs_b, vkeys = _batch(p, batch, 5, 2000, dev)
    batches = [prover.prove_batch(p, wit, state_b, crs_b,
                                  [keys.fold_in(k, i) for k in vkeys])
               for i in range(iters)]
    if not bool(verifier.verify_report_batch(p, state_b, batches[0],
                                             crs_b)["all"].all()):
        raise AssertionError("batch proofs failed verification")

    def run():
        for pf in batches:
            verifier.verify_report_batch(p, state_b, pf, crs_b)

    return batch * iters / _timed(run, dev)


def bench_verify_profile(n: int = 2, r: int = 2, device="cuda",
                         kappa: int = 0) -> dict:
    """Seconds a proof of each check's section of ``verify_report``, and
    of the whole call ("all"), over 4 distinct proofs after a warm-up.
    The JAX package times each check as its own program, from which XLA
    eliminates the rest; PyTorch has no such elimination, so here each
    section is timed in place by a ``utils.profiling.PhaseTimer`` (device
    syncs around each section, only when a timer is passed): a tensor that
    several checks share counts in the first of them, and nothing is
    counted twice."""
    from .utils.profiling import PhaseTimer

    dev = torch.device(device)
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    witness, state, crs, kv = _instance(p, 13, 0x9E0F, dev)
    proofs = [prover.prove(p, witness, state, crs, keys.fold_in(kv, i))
              for i in range(4)]
    verifier.verify_report(p, state, proofs[0], crs, timer=PhaseTimer(dev))
    timer = PhaseTimer(dev)
    whole = 0.0
    for pf in proofs:
        whole += _timed(lambda pf=pf: verifier.verify_report(
            p, state, pf, crs, timer=timer), dev)
    out = {k: v / len(proofs) for k, v in timer.phases.items()}
    out["all"] = whole / len(proofs)
    return out


def bench_phases(n: int = 2, r: int = 2, iters: int = 3, device="cuda",
                 kappa: int = 0) -> dict:
    """Seconds a prove of each phase of ``prover.prove_checkpointed``
    (a ``PhaseTimer``), the mean of ``iters`` proves with distinct
    verifier keys after a warm-up."""
    from .utils.profiling import PhaseTimer

    dev = torch.device(device)
    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    witness, state, crs, kv = _instance(p, 11, 0xBEEF, dev)
    prover.prove_checkpointed(p, witness, state, crs, kv,
                              timer=PhaseTimer(dev))         # warm-up
    timer = PhaseTimer(dev)
    for i in range(iters):
        prover.prove_checkpointed(p, witness, state, crs,
                                  keys.fold_in(kv, i), timer=timer)
    return {k: v / iters for k, v in timer.phases.items()}


def _device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or what
    a CPU run is."""
    if device.type == "cpu":
        return "device: cpu (the plain PyTorch versions of the kernels)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m labrador_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="a short polymul run, no e2e (a smoke run)")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain PyTorch versions on the CPU")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--batch-prove", type=int, default=0, metavar="B",
                    help="also measure batched proofs/s at batch B")
    ap.add_argument("--batch-verify", type=int, default=0, metavar="B",
                    help="also measure batched proofs verified/s at batch B")
    ap.add_argument("--verify-profile", action="store_true",
                    help="also time each check of the verifier")
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase of the prover")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        _stderr("bench: no CUDA device (pass --cpu for the plain versions "
                "on the CPU)")
        return 2
    _stderr(_device_line(device))
    if device.type == "cuda":
        _stderr(f"device: {torch.cuda.get_device_name(0)}, torch "
                f"{torch.__version__}, cuda {torch.version.cuda}")
        batch, scan_len = 65_536, (64 if args.quick else 8192)
    else:
        batch, scan_len = 8_192, (2 if args.quick else 8)
    iters = 2 if args.quick else 4
    ops = bench_polymul(batch, scan_len, iters, device)
    _stderr(f"polymul (_bhat, {device.type}): {ops:,.0f} ops/s "
            f"(batch={batch} x {scan_len} steps)")
    vs = 0.0
    if BASELINE.exists():
        vs = ops / json.loads(BASELINE.read_text())[
            "rq_ntt_polymul_ops_per_s_cpu"]
    # the one JSON line goes out before the longer sections, as bench.py's
    print(json.dumps({"metric": "rq_ntt_polymul_ops_per_s",
                      "value": round(ops, 1), "unit": "ops/s",
                      "vs_baseline": round(vs, 3)}), flush=True)

    if not (args.quick or args.skip_e2e):
        e2e = bench_e2e(device=device)
        _stderr(f"e2e prove: {e2e['prove_s'] * 1e3:.2f} ms, verify: "
                f"{e2e['verify_s'] * 1e3:.2f} ms, proof: "
                f"{e2e['proof_kb']:.1f} KB")
    if args.batch_prove:
        pps = bench_batch_prove(args.batch_prove, device=device)
        _stderr(f"batched prover throughput: {pps:.2f} proofs/s "
                f"(batch={args.batch_prove})")
    if args.batch_verify:
        vps = bench_batch_verify(args.batch_verify, device=device)
        _stderr(f"batched verifier throughput: {vps:.2f} proofs/s "
                f"(batch={args.batch_verify})")
    if args.verify_profile:
        prof = bench_verify_profile(device=device)
        _stderr("per-check verifier profile (sections of one verify_report "
                "call, device syncs around each): "
                + ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in prof.items()))
    if args.phases:
        timings = bench_phases(device=device)
        _stderr("per-phase prover timings: "
                + ", ".join(f"{k}={v * 1e3:.2f}ms"
                            for k, v in timings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

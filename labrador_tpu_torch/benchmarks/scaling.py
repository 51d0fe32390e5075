"""End-to-end prove and verify scaling, the counterpart of
``benchmarks/scaling.py`` and of the reference's
``benches/labrador_perf.rs:11-49``: the witness grows from 2^2 ring
elements by alternately doubling n and r, and each size from 2^--min-pow
to 2^--max-pow coefficients (r * n * 64) is proved and verified.

Per size (seeds of the JAX script: keys from the size's index i in the
sweep, 2 for the first, CRS seed 0xBE7C + i): one first prove, then ``--iters`` proves, each with the
verifier key fold_in(kv, i), and as many verifies, each timed by the
host clock after a device sync; the proof size.  One JSON line per size,
with the device's name (and on a card its power limit).  ``--kappa``
bounds the commitment rank (0: the reference's n * d rule, quadratic in
the witness).  ``--big-q`` runs at q = 4294967311 with exact digits, where
a large witness is not halved to zero.  From the root of the repository:

    python -m labrador_tpu_torch.benchmarks.scaling --max-pow 14 --kappa 256
    python -m labrador_tpu_torch.benchmarks.scaling --device cpu \\
        --min-pow 8 --max-pow 8 --iters 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from labrador_tpu_torch.benchmarks.common import card, require_device, sync


def sizes(max_pow: int) -> list[tuple[int, int, int]]:
    """(index, n, r) of the sweep: from n = r = 2 (index 2), doubling n
    then r in turn, up to 2^max_pow coefficients."""
    out, n, r = [], 2, 2
    for idx in range(2, max_pow - 5 + 1):
        out.append((idx, n, r))
        if idx % 2 == 0:
            n *= 2
        else:
            r *= 2
    return [(x, n_, r_) for x, n_, r_ in out
            if (n_ * r_ * 64).bit_length() - 1 <= max_pow]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-pow", type=int, default=10,
                    help="largest log2 of the witness coefficients r*n*d")
    ap.add_argument("--min-pow", type=int, default=8)
    ap.add_argument("--kappa", type=int, default=0,
                    help="commitment rank (0: the reference's n*d rule)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--big-q", action="store_true",
                    help="q = 4294967311, exact digits")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    from labrador_tpu_torch import keys, prover, sampling, structs, verifier
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.params import LabradorParams

    dev, name = args.device, card(args.device)
    extra = dict(q_start=(1 << 32) - 1, exact_digits=True) \
        if args.big_q else {}
    decomp = "exact" if args.big_q else "reference"
    rows = []
    for idx, n, r in sizes(args.max_pow):
        coeffs = n * r * 64
        if coeffs.bit_length() - 1 < args.min_pow:
            continue
        p = LabradorParams(n=n, r=r, kappa_override=args.kappa, **extra)
        kw, ks, kv = keys.split(keys.key(idx), 3)
        sync(dev)
        t0 = time.perf_counter()
        witness = sampling.generate_witness(kw, p, dev)
        state = structs.generate_state(ks, witness, p)
        crs = CRS.create(p, seed=0xBE7C + idx)

        def prove(vk):
            return prover.prove(p, witness, state, crs, vk, decomp)

        proof = prove(kv)
        sync(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
        prove_ms, proofs = [], []
        for i in range(args.iters):
            sync(dev)
            t0 = time.perf_counter()
            proofs.append(prove(keys.fold_in(kv, i)))
            sync(dev)
            prove_ms.append((time.perf_counter() - t0) * 1e3)
        ok, verify_ms = True, []
        for pf in [proof] + proofs:
            sync(dev)
            t0 = time.perf_counter()
            ok &= bool(verifier.verify_report(p, state, pf, crs,
                                              decomp)["all"])
            sync(dev)
            verify_ms.append((time.perf_counter() - t0) * 1e3)
        verify_ms = verify_ms[1:]
        row = {"witness_coeffs": coeffs, "n": n, "r": r, "kappa": p.kappa,
               "q": p.q,
               "prove_ms": statistics.median(prove_ms) if prove_ms else None,
               "prove_ms_all": prove_ms,
               "verify_ms": statistics.median(verify_ms) if verify_ms
               else None, "verify_ms_all": verify_ms,
               "proof_bytes": structs.transcript_size_in_bytes(proof, p.q),
               "verified": ok, "first_run_ms": first_ms, "device": name}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()

"""Recursion size and time accounting (the structure of BASELINE config 5),
the counterpart of ``benchmarks/recursion_size.py``.

Proves a base instance (exact digits; seeds of the JAX script: keys from
1, CRS seed 0x512E), folds the proof into the structured recursive
instance (``recursion.fold``) for each (mu, kappa') of ``--mu`` x
``--kappa-new``, and proves (``prove_checkpointed``, verifier key
fold_in(kv, 16 * combination + level)) and verifies each folded level
with its own CRS (seed 0xF01D + level), ``--levels`` deep along each
combination.  One JSON line per level: sizes (``transcript_size_in_bytes``,
zlib-9 of the bincode, and its ``fs=True`` variant) and host-clock times
after a device sync, with the device's name (and on a card its power
limit).  ``--fs-size-only`` skips the interactive size, whose zlib pass
over the JL matrices of a folded 2^14 proof takes minutes on the host.
From the root of the repository:

    python -m labrador_tpu_torch.benchmarks.recursion_size --big-q \\
        --mu 16 132 --fs-size-only
    python -m labrador_tpu_torch.benchmarks.recursion_size --device cpu \\
        --n 2 --r 2 --kappa 16 --mu 4
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

from labrador_tpu_torch.benchmarks.common import card, require_device, sync


def _sizes(proof, q: int, fs_only: bool) -> dict:
    from labrador_tpu_torch import structs
    out = {"fs_proof_bytes": structs.transcript_size_in_bytes(proof, q,
                                                              fs=True)}
    if not fs_only:
        out["proof_bytes"] = structs.transcript_size_in_bytes(proof, q)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--r", type=int, default=16)
    ap.add_argument("--kappa", type=int, default=256)
    ap.add_argument("--kappa-new", type=int, nargs="+", default=[16])
    ap.add_argument("--mu", type=int, nargs="+", default=[8])
    ap.add_argument("--levels", type=int, default=1)
    ap.add_argument("--big-q", action="store_true",
                    help="q = 4294967311")
    ap.add_argument("--fs-size-only", action="store_true",
                    help="skip the interactive (pi included) proof size")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    from labrador_tpu_torch import (keys, prover, recursion, sampling,
                                    structs, verifier)
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.params import LabradorParams

    dev, name = args.device, card(args.device)
    kw = dict(q_start=(1 << 32) - 1) if args.big_q else {}
    p = LabradorParams(n=args.n, r=args.r, kappa_override=args.kappa,
                       exact_digits=True, **kw)
    kw_, ks, kv = keys.split(keys.key(1), 3)
    w = sampling.generate_witness(kw_, p, dev)
    state = structs.generate_state(ks, w, p)
    crs = CRS.create(p, seed=0x512E)
    sync(dev)
    t0 = time.perf_counter()
    proof = prover.prove(p, w, state, crs, kv, decomp_mode="exact")
    sync(dev)
    rows = [dict(level=0, n=p.n, r=p.r, kappa=p.kappa, q=p.q,
                 witness_coeffs=p.n * p.r * p.d,
                 prove_ms=(time.perf_counter() - t0) * 1e3,
                 **_sizes(proof, p.q, args.fs_size_only), device=name)]
    print(json.dumps(rows[-1]), flush=True)

    # each (mu, kappa') folds the same base proof; the levels follow it
    combos = itertools.product(args.mu, args.kappa_new)
    for ci, (mu, kappa_new) in enumerate(combos):
        p1, state1, proof1, crs1 = p, state, proof, crs
        for lvl in range(1, args.levels + 1):
            sync(dev)
            t0 = time.perf_counter()
            p2, w2, st2, _ = recursion.fold(p1, state1, proof1, crs1, mu=mu,
                                            kappa_new=kappa_new)
            sync(dev)
            t1 = time.perf_counter()
            crs2 = CRS.create(p2, seed=0xF01D + lvl)
            proof2 = prover.prove_checkpointed(
                p2, w2, st2, crs2, keys.fold_in(kv, 16 * ci + lvl),
                decomp_mode="exact")
            sync(dev)
            t2 = time.perf_counter()
            assert bool(proof2.jl_ok) and bool(proof2.b_pp_ok)
            rep = verifier.verify_report(p2, st2, proof2, crs2,
                                         decomp_mode="exact")
            sync(dev)
            t3 = time.perf_counter()
            rows.append(dict(
                level=lvl, mu=mu, kappa_new=kappa_new, n=p2.n, r=p2.r,
                k_families=p2.k_count, witness_coeffs=p2.n * p2.r * p2.d,
                fold_ms=(t1 - t0) * 1e3, prove_ms=(t2 - t1) * 1e3,
                verify_ms=(t3 - t2) * 1e3, verified=bool(rep["all"]),
                **_sizes(proof2, p2.q, args.fs_size_only), device=name))
            print(json.dumps(rows[-1]), flush=True)
            p1, state1, proof1, crs1 = p2, st2, proof2, crs2
    return rows


if __name__ == "__main__":
    main()

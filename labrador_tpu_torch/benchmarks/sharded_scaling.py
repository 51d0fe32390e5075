"""Rows-axis scaling of the port's sharded prover (the structure of
BASELINE.json config 4), the counterpart of ``benchmarks/sharded_scaling.py``.

The same proof instance (seeds of the JAX script: keys from 17, CRS seed
0x40D5) goes through ``parallel.sharded.make_sharded_prover`` on a (dp 1,
rows R) mesh for each R in ``--rows-list``: one prove, whose transcript
must equal a single-rank ``prover.prove``'s (the script raises if not),
then ``--iters`` timed proves, each with the verifier key fold_in(kv, i).
One JSON line per mesh, with the device's name and, on a card, its power
limit.

Two ways to run it, from the root of the repository:

* Ranks on one host that share cuda:0 (or the CPU, ``--device cpu``),
  over gloo: the script spawns a world of R processes for each R.

      python -m labrador_tpu_torch.benchmarks.sharded_scaling \\
          --n 16 --r 16 --kappa 256 --rows-list 1 2 4

  Ranks that share one card show that the sharded prover is exact on it
  and what its collectives cost (gloo stages them through host memory),
  not a speed-up: every rank draws on the same SMs and host cores.
* R cards under ``torchrun``, one rank a card, over NCCL (one R a
  launch; not measured yet):

      torchrun --nproc-per-node 4 -m \\
          labrador_tpu_torch.benchmarks.sharded_scaling --backend nccl

Each time is the host clock around proves that end in a device sync.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def _card(device: str) -> str:
    """The device as nvidia-smi names it, with its power limit, or the
    CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _instance(args, device):
    """(params, witness, state, CRS, verifier key, decomposition mode)."""
    from labrador_tpu_torch import keys, sampling, structs
    from labrador_tpu_torch.cli import make_params
    from labrador_tpu_torch.crs import CRS

    p = make_params(args.n, args.r, args.kappa, False, args.big_q)
    kw, ks, kv = keys.split(keys.key(17), 3)
    witness = sampling.generate_witness(kw, p, device)
    state = structs.generate_state(ks, witness, p)
    crs = CRS.create(p, seed=0x40D5)
    return p, witness, state, crs, kv, "exact" if args.big_q else "reference"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def single_rank(args, device) -> tuple[str, float]:
    """The digest of one unsharded prove of the instance, and its ms."""
    from labrador_tpu_torch import prover, structs

    p, w, st, crs, kv, mode = _instance(args, device)
    _sync(device)
    t0 = time.perf_counter()
    proof = prover.prove(p, w, st, crs, kv, mode)
    _sync(device)
    return (structs.transcript_sha256(proof, p.q),
            (time.perf_counter() - t0) * 1e3)


def run_rank(args, rows: int) -> dict:
    """This rank's part of the mesh (dp 1, rows): the first sharded
    prove's digest and ms, then ``args.iters`` timed proves, and the
    collectives' cost."""
    from labrador_tpu_torch import keys, structs
    from labrador_tpu_torch.parallel.mesh import make_mesh
    from labrador_tpu_torch.parallel.sharded import (make_sharded_prover,
                                                     stack, take)

    mesh = make_mesh(1, rows, backend=args.backend, device=args.device)
    p, w, st, crs, kv, mode = _instance(args, mesh.device)
    fn = make_sharded_prover(p, mesh, mode)
    st_b = stack([st])

    def prove(vkey):
        _sync(mesh.device)
        t0 = time.perf_counter()
        tr = fn(w[None], st_b, [crs.key], [vkey])
        _sync(mesh.device)
        return tr, (time.perf_counter() - t0) * 1e3

    tr, first_ms = prove(kv)
    digest = structs.transcript_sha256(take(tr, 0), p.q)
    times = [prove(keys.fold_in(kv, i))[1] for i in range(args.iters)]
    return {"digest": digest, "first_ms": first_ms, "times_ms": times,
            "collectives": mesh.stats.as_dict()}


def _report(args, rows: int, ranks: list, want: str | None, card: str,
            base: dict) -> dict:
    if want is not None:
        bad = [r["digest"] for r in ranks if r["digest"] != want]
        if bad:
            raise AssertionError(f"rows={rows}: sharded transcript {bad[0]} "
                                 f"!= single-rank {want}")
    ms = statistics.mean(ranks[0]["times_ms"])
    if "ms" not in base:
        base.update(ms=ms, rows=rows)
    return {"rows": rows, "backend": args.backend, "device": card,
            "n": args.n, "r": args.r, "kappa": args.kappa,
            "big_q": args.big_q, "prove_ms": ms,
            "prove_ms_by_rank": [statistics.mean(r["times_ms"])
                                 for r in ranks],
            "eff_vs_linear": base["ms"] * base["rows"] / rows / ms,
            "first_run_ms": ranks[0]["first_ms"],
            "parity_checked": want is not None,
            "collectives_rank0": ranks[0]["collectives"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--kappa", type=int, default=256)
    ap.add_argument("--big-q", action="store_true",
                    help="q = 4294967311, exact digits")
    ap.add_argument("--rows-list", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="gloo: ranks share one card or the CPU; nccl: one "
                         "card a rank (under torchrun)")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the single-rank transcript check")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")

    from labrador_tpu_torch.parallel import multihost

    if "RANK" in os.environ:                 # one rank of a torchrun job
        multihost.initialize(backend=args.backend)
        import torch.distributed as dist
        rows = dist.get_world_size()
        from labrador_tpu_torch.parallel.mesh import rank_device
        device = rank_device(args.device)
        want = None if args.skip_parity else single_rank(args, device)[0]
        mine = run_rank(args, rows)
        ranks = [None] * rows
        dist.all_gather_object(ranks, mine)
        if multihost.is_coordinator():
            print(json.dumps(_report(args, rows, ranks, want,
                                     _card(args.device), {})), flush=True)
        dist.destroy_process_group()
        return 0

    if args.backend != "gloo":
        raise SystemExit("ranks spawned on one host share its card: "
                         "--backend gloo (run nccl under torchrun)")
    card = _card(args.device)
    want = None
    if not args.skip_parity:
        want, ms = single_rank(args, args.device)
        print(f"# single-rank prove {ms:.2f} ms (first run) on {card}",
              file=sys.stderr, flush=True)
    if args.device == "cuda":
        from labrador_tpu_torch.ops import cuda_lib
        cuda_lib.load()               # built once here, loaded by the ranks
        torch.cuda.empty_cache()
    base: dict = {}
    for rows in args.rows_list:
        if args.kappa % rows:
            print(f"# skip rows={rows}: kappa={args.kappa} not divisible",
                  file=sys.stderr, flush=True)
            continue
        ranks = multihost.spawn_local(run_rank, rows, (args, rows),
                                      threads=2)
        print(json.dumps(_report(args, rows, ranks, want, card, base)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

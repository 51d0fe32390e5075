"""The Ajtai commitment kernel and the u1 B-term kernel against their plain
PyTorch versions, the counterpart of ``benchmarks/ajtai_bench.py``.

At the JAX script's shape (kappa = 2048, n = 128, r = 4, q = 8191, CRS
seed 0xBE7C): a distinct witness of uniform residues for every timed call
(numpy seed 100; a witness that the sampler halves to its norm bound
would be almost all zeros at this size), the kernel's result held bit-equal to the plain version's on the
first, then the mean time of ``--iters`` kernel calls and of one call
of the plain version (the plain u1 B-term draws 8.6 G CRS entries) (the JAX script's "XLA
streamed path" becomes the port's plain version: the same contraction in
torch ops, with the CRS drawn by torch-op Threefry; it is the kernel's
reference, not a library call).  Then the same for the u1 B-term on the
witnesses' t digits.  Times: CUDA events on a card, the host clock on
the CPU (where "kernel" is the plain version too).  One JSON line per
kernel, with the device's name (and on a card its power limit).  From the
root of the repository:

    python -m labrador_tpu_torch.benchmarks.ajtai_bench
    python -m labrador_tpu_torch.benchmarks.ajtai_bench --device cpu \\
        --kappa 16 --n 2 --r 2 --iters 2
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from labrador_tpu_torch.benchmarks.common import card, mean_ms, require_device

PLAIN_ITERS = 1


def bench(label: str, kernel, plain, inputs: list, plain_iters: int,
          device, shape: dict) -> dict:
    """Hold kernel(x) bit-equal to plain(x) on inputs[0], then time both;
    print and return the JSON row."""
    if not torch.equal(kernel(inputs[0]), plain(inputs[0])):
        raise AssertionError(f"{label}: kernel != plain")
    row = {"kernel": label, **shape, "bit_equal": True,
           "kernel_ms": mean_ms(kernel, inputs, device),
           "plain_ms": mean_ms(plain, inputs[:plain_iters], device),
           "iters": len(inputs), "plain_iters": plain_iters,
           "device": card(device)}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kappa", type=int, default=2048)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    from labrador_tpu_torch import protocol
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.ops import ajtai_cuda, u1_cuda
    from labrador_tpu_torch.params import LabradorParams

    dev = args.device
    p = LabradorParams(n=args.n, r=args.r, kappa_override=args.kappa)
    crs = CRS.create(p, seed=0xBE7C)
    rng = np.random.default_rng(100)
    ws = [torch.from_numpy(rng.integers(0, p.q, (p.r, p.n, p.d))).to(dev)
          for _ in range(args.iters)]
    shape = {"kappa": p.kappa, "n": p.n, "r": p.r, "q": p.q}
    rows = [bench("ajtai_commit", lambda w: ajtai_cuda.ajtai_commit(crs, w),
                  lambda w: ajtai_cuda.ajtai_commit_plain(crs, w), ws,
                  PLAIN_ITERS, dev, shape)]
    t_digs = [protocol.decompose_t(ajtai_cuda.ajtai_commit(crs, w), p,
                                   "reference") for w in ws]
    rows.append(bench("u1_bterm", lambda t: u1_cuda.u1_bterm(crs, t),
                      lambda t: u1_cuda.u1_bterm_plain(crs, t), t_digs,
                      PLAIN_ITERS, dev,
                      {**shape, "kappa_1": p.kappa_1, "t_1": p.t_1}))
    return rows


if __name__ == "__main__":
    main()

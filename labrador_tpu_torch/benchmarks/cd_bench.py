"""The C/D kernel on the u2 D-term against its plain PyTorch version, the
counterpart of ``benchmarks/cd_bench.py``.

u2 = sum_{i <= j, k} D_ijk h_ij^(k), the outer-commitment tail that grows
with r^2, at the JAX script's shape (kappa = 256, n = 16, r = 32: 528
triangle pairs, q = 8191, CRS seed 0xD0D0).  A distinct h digit stream for
every timed call (balanced digits of base b_1, symmetric in (i, j) as h,
from numpy seed 5), the kernel's result held bit-equal to the plain
version's on the first, then the mean time of ``--iters`` kernel calls
and of PLAIN_ITERS plain calls (the JAX script's XLA path becomes
the port's plain version: the same contraction in torch ops; the
kernel's reference, not a library call).  Times: CUDA events on a card,
the host clock on the CPU.  One JSON line, with the device's name (and on
a card its power limit).  From the root of the repository:

    python -m labrador_tpu_torch.benchmarks.cd_bench
    python -m labrador_tpu_torch.benchmarks.cd_bench --device cpu \\
        --kappa 16 --n 2 --r 4 --iters 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from labrador_tpu_torch.benchmarks.ajtai_bench import bench
from labrador_tpu_torch.benchmarks.common import require_device

PLAIN_ITERS = 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kappa", type=int, default=256)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--r", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.ops import cd_cuda
    from labrador_tpu_torch.params import LabradorParams
    from labrador_tpu_torch.protocol import _tri_stream

    p = LabradorParams(n=args.n, r=args.r, kappa_override=args.kappa)
    crs = CRS.create(p, seed=0xD0D0)
    rng = np.random.default_rng(5)
    half = p.b_1 // 2

    def h_stream():
        d = rng.integers(-half, half + 1, (p.t_1, p.r, p.r, p.d))
        d = (d + d.transpose(0, 2, 1, 3)) // 2          # symmetric, as h
        dig = torch.from_numpy(np.mod(d, p.q)).to(args.device)
        return _tri_stream(dig, p)

    streams = [h_stream() for _ in range(args.iters)]
    n_tri = p.r * (p.r + 1) // 2
    return bench(
        "cd_sum", lambda h: cd_cuda.cd_sum(crs, h, crs._off_d, p.t_1),
        lambda h: cd_cuda.cd_sum_plain(crs, h, crs._off_d, p.t_1), streams,
        PLAIN_ITERS, args.device,
        {"kappa": p.kappa, "n": p.n, "r": p.r, "q": p.q, "kappa_2": p.kappa_2,
         "triangle_pairs": n_tri, "L": n_tri * p.t_1})


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) is proved and verified in a closed loop for ``--seconds``
on one NVIDIA card; the last line on standard output is the result's
JSON object, and the numbers held to their limits are the last lines on
standard error.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics and the device trace.  Exits 2,
printing no result, without the cards the cell asks for, and 3 if JAX or
the JAX package was loaded into the process.
"""

import time

T_PROCESS = time.time()     # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "labrador_tpu")
TORCH_THREADS = 4


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules (the part before the first dot,
    compared whole) that belong to JAX or to the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be nonnegative")

    import torch
    from perfbench.lib import runner, spec

    cell = spec.resolve(spec.load_benchmark(ROOT / "BENCHMARK.json"), ROOT,
                        args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(TORCH_THREADS)
    result, info, checks = runner.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}")
    for line in info:
        print(line)
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

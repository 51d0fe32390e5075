"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/control.py --workload <name> --seeds <n> ...
                                 --control-seeds <n> ... [--device cuda]

For each of ``--seeds`` the program runs the cell's own statements for as
many steps as a run compares (the mix's ``check_sample``) and is judged
as a run judges it (``lib/correct``): the lower readings.  For each of
``--control-seeds`` the control takes the program's place: the reference
with its products of residues in float64 (``reference/lowprec``), one
precision below the configuration's exact 64-bit arithmetic, judged the
same way: the upper readings.  One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.lib import correct, spec  # noqa: E402
from perfbench.reference import lowprec  # noqa: E402


class Control:
    """A cell's traffic (``lib/proofs``) with the control in the
    program's place: the reference's step in lower precision."""

    def __init__(self, traffic):
        self.traffic = traffic

    def __getattr__(self, name):
        return getattr(self.traffic, name)

    def prove(self, step: int):
        with lowprec.lower_precision():
            return self.traffic.reference_prove(step)

    def verify(self, step: int, proof, timer=None):
        with lowprec.lower_precision():
            return self.traffic.reference_verify(step, proof)

    def bincode(self, proof) -> tuple[int, str]:
        return self.traffic.reference_bincode(proof)


def readings(cell: spec.Cell, seed: int, control: bool, device,
             seconds: dict | None = None) -> dict:
    """The compared numbers of ``check_sample`` steps of the cell, with
    the program or the control proving and verifying; ``seconds``
    collects the check's parts' times."""
    traffic = spec.make_traffic(cell, seed, device)
    if control:
        traffic = Control(traffic)
    items, rejected = [], []
    for step in range(int(cell.traffic["check_sample"])):
        proof = traffic.prove(step)
        answer = traffic.verify(step, proof)
        items.append((step, proof, answer))
        if not traffic.accepted(answer):
            rejected.append(items[-1])
    return correct.compare(traffic, items, rejected, 0, seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(ROOT / "BENCHMARK.json"), ROOT,
                        args.workload)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0, parts = time.perf_counter(), {}
            values = readings(cell, seed, control, args.device, parts)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": "control" if control else "program",
                              "values": values, "correct":
                              correct.within(values),
                              "seconds": time.perf_counter() - t0,
                              "check_seconds": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the port's benchmark scripts share: the device's name (with its
power limit on a card), device syncs and a timer of calls on distinct
inputs."""

from __future__ import annotations

import subprocess
import time

import torch


def card(device) -> str:
    """The device as ``nvidia-smi --query-gpu=name,power.limit`` names it
    (name and power limit), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def require_device(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mean_ms(fn, inputs: list, device) -> float:
    """Mean milliseconds of fn(x) over ``inputs``, one call each, after a
    warm-up call on inputs[0]: CUDA events around the calls on a card
    (distinct inputs, so no call repeats another), the host clock after a
    sync on the CPU."""
    fn(inputs[0])
    sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in inputs:
            fn(x)
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / len(inputs)
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / len(inputs)

"""Per-phase timing of the prover.

Counterpart of ``labrador_tpu/utils/profiling.py`` (``PhaseTimer``).  On
a CUDA device a phase's time runs from a synchronize before it to one
after it, so it holds the device work the phase queued, not only its
launches; on the CPU the host clock alone.  The device defaults to
``"cuda"``, as every entry point of the port: a CPU caller passes
``"cpu"``.
"""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Named phase durations in seconds, summed over repeats."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.phases: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v * 1e3:.2f} ms ({v / total * 100:.1f}%)"
                 for k, v in sorted(self.phases.items(),
                                    key=lambda kv: -kv[1])]
        lines.append(f"total: {total * 1e3:.2f} ms")
        return "\n".join(lines)


def section(timer: PhaseTimer | None, name: str):
    """``timer.phase(name)`` (device syncs around the section) where a
    timer is given, else nothing."""
    return timer.phase(name) if timer is not None \
        else contextlib.nullcontext()

"""The device trace of a traced window, from ``torch.profiler`` (CUPTI).

The traced window runs from the first ``step.prove`` span to the end of
the last ``step.verify`` span of the profiled steps.  ``busy_s`` is the
union of the device's activity (kernels, copies, sets) inside it; an idle
gap is a stretch of it with no device activity, named by the innermost
of the benchmark's own spans (``step.*``, ``prover.*``, ``verifier.*``,
``kernels.*``) that the host was in at the gap's midpoint.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

SPAN_PREFIXES = ("step.", "prover.", "verifier.", "kernels.")
TOP = 10


@dataclass
class Trace:
    """Times in seconds from the trace's origin.  ``device``: (name,
    start, end) of each device activity; ``spans``: (name, start, end) of
    the benchmark's host spans."""

    device: list
    spans: list
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        iv = sorted((max(s, self.start), min(e, self.end))
                    for _, s, e in self.device if e > self.start
                    and s < self.end)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_ops(self) -> list:
        """The device operations that took most time, summed by name."""
        tot = defaultdict(float)
        for n, s, e in self.device:
            tot[short_name(n)] += e - s
        return sorted(([n, t] for n, t in tot.items()),
                      key=lambda x: -x[1])[:TOP]

    def idle_gaps(self) -> list:
        """The idle time of the window summed by what the host was doing,
        the longest first."""
        gaps, prev = [], self.start
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end > prev:
            gaps.append((prev, self.end))
        # sweep the gaps' midpoints over the spans sorted by start: the
        # open spans nest, so the innermost is the one opened last
        spans = sorted(self.spans, key=lambda x: x[1])
        tot, open_, k = defaultdict(float), [], 0
        for s, e in sorted(gaps):
            mid = (s + e) / 2
            while k < len(spans) and spans[k][1] <= mid:
                open_.append(spans[k])
                k += 1
            open_ = [sp for sp in open_ if sp[2] > mid]
            tot[open_[-1][0] if open_ else "harness"] += e - s
        return sorted(([n, t] for n, t in tot.items()),
                      key=lambda x: -x[1])[:TOP]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list, at most 160 letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


def from_profiler(prof) -> Trace | None:
    """The Trace of a stopped ``torch.profiler.profile``, or None where it
    holds no step spans."""
    device, spans = [], []
    for ev in prof.events():
        t0, t1 = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name.startswith(SPAN_PREFIXES):
            # the device side's copy of a span is an annotation, no work
            if ev.device_type.name == "CPU":
                spans.append((ev.name, t0, t1))
        elif ev.device_type.name in ("CUDA", "PrivateUse1"):
            device.append((ev.name, t0, t1))
    steps = [(s, e) for n, s, e in spans if n.startswith("step.")]
    if not steps:
        return None
    return Trace(device, spans, min(s for s, _ in steps),
                 max(e for _, e in steps))

"""The timed window: a closed loop of steps, the spans around the
program's functions in a traced run, and the end-to-end metrics.

Each step is the prove call, ending in a device sync, then the verify
call of its proof, ending in a sync.  The two durations tile the window;
what lies outside both (the loop itself, the sample's bookkeeping) is
reported apart as the untiled remainder.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import random
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


# distinct rejected proofs kept for the reference.  An honest proof fails
# check 14's ||z||^2 <= 2 gamma about once in 6,000 (PERF.md section 7);
# a deterministic protocol (Fiat-Shamir) repeats such a proof on every
# step of its statement, and each repeat is judged with the kept proof.
REJECTED_KEPT = 3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Record:
    """What a window measured.  ``rejected``: (step, proof, answer) of each
    step whose verdict rejected its proof (the proof kept for the reference,
    shared by the steps that repeat it, or None beyond those kept);
    ``errors``: steps that raised.
    ``spans``: seconds of each probed call by
    span name, outside the profiled steps (the profiler slows the host);
    ``calls``: what each probed call describes of itself, with whether
    the profiler was on; ``sections``: the verifier's sections
    (``verify_report(timer=)``) summed over the steps after the profiled
    ones; ``trace``: the profiled steps of a traced window
    (``trace.Trace``), or None."""

    prove_s: list[float] = field(default_factory=list)
    verify_s: list[float] = field(default_factory=list)
    rejected: list = field(default_factory=list)
    errors: int = 0
    window_s: float = 0.0
    spans: dict = field(default_factory=lambda: defaultdict(list))
    calls: dict = field(default_factory=lambda: defaultdict(list))
    sections: dict = field(default_factory=dict)
    profiling: bool = False
    profiled_steps: int = 0
    trace: object = None

    @property
    def proofs(self) -> int:
        return len(self.prove_s)

    @property
    def verifies(self) -> int:
        return len(self.verify_s)

    @property
    def timed_verifies(self) -> int:
        """The verifies that ``sections`` sums over."""
        return self.verifies - self.profiled_steps

    @property
    def untiled_s(self) -> float:
        return self.window_s - sum(self.prove_s) - sum(self.verify_s)


# -- spans around the program's functions ------------------------------------

@dataclass(frozen=True)
class Probe:
    """A span around ``target`` (``module.attribute`` of the program):
    with ``timed`` the call is timed between device syncs; ``describe``
    (a function of the call's arguments) records what the call does."""

    target: str
    span: str
    timed: bool = True
    describe: object = None


def probes_of(entries) -> list[Probe]:
    """Probes from the ``PROBES`` entries (dicts) of ``spans.json`` and of
    the metric readers, one a target.  Two readers may declare the same
    probe; two different probes of one target raise ValueError."""
    out: dict[str, Probe] = {}
    for e in entries:
        p = Probe(**e)
        if out.setdefault(p.target, p) != p:
            raise ValueError(f"two different probes of {p.target}: "
                             f"{out[p.target]} and {p}")
    return list(out.values())


@contextlib.contextmanager
def installed(probes: list[Probe], rec: Record, device: torch.device):
    """Each probe's wrapper set in place of its target for the block."""
    saved = []
    try:
        for p in probes:
            mod_name, attr = p.target.rsplit(".", 1)
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, p, rec, device))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _wrap(fn, probe: Probe, rec: Record, device: torch.device):
    def wrapper(*args, **kwargs):
        if probe.describe is not None:
            rec.calls[probe.span].append(
                (rec.profiling, probe.describe(*args, **kwargs)))
        if not probe.timed:
            with torch.profiler.record_function(probe.span):
                return fn(*args, **kwargs)
        sync(device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(probe.span):
            out = fn(*args, **kwargs)
        sync(device)
        if not rec.profiling:
            rec.spans[probe.span].append(time.perf_counter() - t0)
        return out
    return wrapper


def section_timer(device: torch.device):
    """The program's ``PhaseTimer`` whose sections also open a profiler
    span ``verifier.<section>``."""
    from labrador_tpu_torch.utils.profiling import PhaseTimer

    class SpanTimer(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name: str):
            with torch.profiler.record_function("verifier." + name):
                with super().phase(name):
                    yield

    return SpanTimer(device)


# -- the sample the reference recomputes -------------------------------------

class Sample:
    """A uniform sample of ``size`` of the window's steps, drawn from the
    seed (reservoir sampling): (step, proof, answer) of each."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed * 0x2545F491 + 0x5A17)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = item

    def steps(self) -> list:
        return sorted(self.items, key=lambda it: it[0])


# -- the window ---------------------------------------------------------------

def run_window(traffic, seconds: float, device: torch.device, rec: Record,
               sample: Sample, timer=None, profiler=None,
               trace_steps: int = 0) -> None:
    """Steps until ``seconds`` have passed (the step that crosses the end
    runs out).  With ``profiler`` (a started ``torch.profiler.profile``)
    the first ``trace_steps`` steps are profiled, then it stops."""
    sync(device)
    rec.profiling = profiler is not None
    t_start = time.perf_counter()
    step = 0
    while time.perf_counter() - t_start < seconds:
        if rec.profiling and step == trace_steps:
            _stop(profiler, rec, step, timer, device)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("step.prove"):
                proof = traffic.prove(step)
            sync(device)
            t1 = time.perf_counter()
            with torch.profiler.record_function("step.verify"):
                answer = traffic.verify(step, proof, timer)
            sync(device)
            t2 = time.perf_counter()
        except Exception:               # a failed step counts; see errors
            import traceback
            traceback.print_exc()
            rec.errors += 1
            if rec.errors > 3:
                break
            step += 1
            continue
        rec.prove_s.append(t1 - t0)
        rec.verify_s.append(t2 - t1)
        if not traffic.accepted(answer):
            rec.rejected.append((step, _kept(traffic, rec.rejected, step,
                                             proof, answer), answer))
        sample.offer((step, proof, answer))
        step += 1
    rec.window_s = time.perf_counter() - t_start
    if rec.profiling:
        _stop(profiler, rec, step, timer, device)
    if timer is not None:
        rec.sections = dict(timer.phases)


def _kept(traffic, rejected: list, step: int, proof, answer):
    """The proof to keep for a rejected step: a kept proof of the same
    statement equal to it with the same verdict (one object, judged once),
    else the proof itself while fewer than ``REJECTED_KEPT`` are kept,
    else None."""
    kept = {id(p): p for _, p, _ in rejected if p is not None}
    for s, p, a in rejected:
        if p is not None and a == answer and traffic.statement(s) == \
                traffic.statement(step) and not traffic.differing(proof, p):
            return p
    return proof if len(kept) < REJECTED_KEPT else None


def _stop(profiler, rec: Record, step: int, timer, device) -> None:
    """End the profiled steps: the sections start again from zero."""
    sync(device)
    profiler.stop()
    rec.profiling = False
    rec.profiled_steps = step
    if timer is not None:
        timer.phases.clear()


# -- end-to-end metrics, by name ----------------------------------------------

_PCT = re.compile(r"^(prove|verify)_p(\d+)_ms$")
_MEAN = re.compile(r"^(prove|verify)_ms$")


def nearest_rank(values: list[float], pct: float) -> float:
    """The pct-th percentile by nearest rank: the smallest value with at
    least pct% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(pct / 100 * len(s)) - 1)]


def end_to_end(name: str, rec: Record, setup_s: float) -> float:
    """``setup_s``; ``<call>_ms``, the summed durations of the window's
    calls over their number; ``<call>_p<N>_ms``, their N-th percentile."""
    if name == "setup_s":
        return setup_s
    m = _MEAN.match(name)
    if m:
        d = rec.prove_s if m[1] == "prove" else rec.verify_s
        return 1e3 * sum(d) / len(d)
    m = _PCT.match(name)
    if m:
        d = rec.prove_s if m[1] == "prove" else rec.verify_s
        return 1e3 * nearest_rank(d, float(m[2]))
    raise KeyError(f"no end-to-end metric {name!r}")

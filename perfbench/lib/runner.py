"""One run of one cell: set-up, the window, the readings, the check.

``run_cell`` takes the device it is given and never looks for a card
itself (``run.py`` does), so the tests drive it on the CPU.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from . import correct, spec, trace, window


def kernel_launches() -> dict:
    """Launches so far of every kernel of the program, by name
    (``cuda_lib.KernelInfo.launches``)."""
    from labrador_tpu_torch.ops import (ajtai_cuda, cd_cuda, cuda_lib,
                                        polymul_cuda, u1_cuda)
    out = {}
    for mod in (ajtai_cuda, u1_cuda, cd_cuda, polymul_cuda):
        for v in vars(mod).values():
            if isinstance(v, cuda_lib.KernelInfo):
                out[v.name] = v.launches
    return out


def readers(cell: spec.Cell, bench_dir: Path) -> dict:
    return {m["name"]: spec.load_reader(m["name"], bench_dir)
            for m in cell.per_layer}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_process: float,
             bench_dir: Path = spec.BENCH_DIR) -> tuple[dict, list, list]:
    """Run ``cell`` once on ``device``; ``t_process`` is the host clock
    (``time.time()``) at the process's start.  Returns the result's
    object, the lines to print before it, and the compared numbers'
    lines (``check <name> <value> limit <limit>``)."""
    dev = torch.device(device)
    mix = cell.traffic
    info = []
    traffic = spec.make_traffic(cell, seed, dev, bench_dir)
    if dev.type == "cuda":
        from labrador_tpu_torch.ops import cuda_lib
        cuda_lib.load()
    # warm-up: one step of the cell's own calls
    proof = traffic.prove(0)
    traffic.verify(0, proof)
    del proof
    window.sync(dev)

    rec = window.Record()
    sample = window.Sample(int(mix["check_sample"]), seed)
    readers_ = readers(cell, bench_dir) if traced else {}
    probes = []
    if traced:
        with open(bench_dir / "spans.json") as f:
            probes = json.load(f)["probes"]
        for r in readers_.values():
            probes += list(getattr(r, "PROBES", []))
    timer = window.section_timer(dev) if traced else None
    launches0 = kernel_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_process
    profiler = None
    with window.installed(window.probes_of(probes), rec, dev):
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        window.run_window(traffic, seconds, dev, rec, sample, timer,
                          profiler, int(mix.get("trace_steps", 0)))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v - launches0.get(k, 0)
                for k, v in kernel_launches().items()
                if v - launches0.get(k, 0)}
    if profiler is not None:
        rec.trace = trace.from_profiler(profiler)
        del profiler

    failed = len(rec.rejected) + rec.errors
    attempted = rec.proofs + rec.errors
    info.append(f"window {rec.window_s:.6f} s, {rec.proofs} steps, "
                f"untiled remainder {rec.untiled_s:.6f} s")
    info.append(f"memory peak of the window (max_memory_allocated) "
                f"{peak} bytes")
    info.append("kernel launches in the window: " + json.dumps(launches))
    info.append("rejected steps: " + json.dumps(
        [[step, failing(answer)] for step, _, answer in rec.rejected]))

    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = readers_[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": window.end_to_end(m["name"], rec,
                                                          setup_s),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}

    items = sample.steps()
    t_check, parts = time.perf_counter(), {}
    values = correct.compare(traffic, items, rec.rejected, rec.errors,
                             parts)
    info.append(f"reference check {time.perf_counter() - t_check:.3f} s: "
                + json.dumps(parts))
    ok = correct.within(values) and bool(items)
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(dev, peak, cell)}
    if traced and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": correct.LIMITS[k]}
                        for k, v in values.items()}
    info.append(f"proofs compared with the reference: {len(items)}")
    return result, info, correct.lines(values)


def failing(answer) -> list:
    """The checks a rejecting verdict failed (``verify_fs`` gives none)."""
    return [k for k, v in answer.items() if not v] \
        if isinstance(answer, dict) else ["verify_fs"]


def device_info(dev: torch.device, peak: int, cell: spec.Cell) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}

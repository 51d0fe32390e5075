"""The port of LaBRADOR on one CUDA card: the kernel time table of
PERF.md §6, then every path of the port, each counted.

* build: the kernels and their ptxas registers and spills;
* table: every row of the case table of ``tests/test_torch_cuda.py``
  (each kernel, mode, modulus and shape) timed with CUDA events, the
  kernel, its plain PyTorch version and its other yardsticks (a library
  call, hashlib, single launches) against the row's ``Work`` bound, with
  the row's launches counted and bit-equality asserted as a guard;
* paths: the flows of that file (``golden_flow`` at config 1 and
  ``FLOWS_2P14``), the 4-rank world of ``tests/test_torch_sharded.py`` and
  the port's ``bench.py``, each with every ``KernelInfo.launches`` zeroed
  before it and read after it.  The flows assert their own results; the
  check of the port on the card is
    python -m pytest tests/test_torch_cuda.py tests/test_torch_sharded.py \
        -m cuda --noconftest -q

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py

Prints a line a row and a path, then the kernel table: one JSON row for
each ``KernelInfo``, timed at its first row in the case table (the 2^14
shapes where the kernel runs there, config 2 for kernel 1), with its
launches in the paths; the last line of standard output is the result
JSON.  Without a CUDA device it exits non-zero before printing any
result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))
import test_torch_cuda as cases  # noqa: E402  (the case table and flows)

KERNEL_REPS, PLAIN_REPS, ALSO_REPS = 10, 1, 3
# a timing runs at least this long (more calls where each is short), so
# that short kernels are timed at the card's working clocks, not at its
# launch overhead alone
MIN_TIMED_MS = 50.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() by CUDA events, over reps calls or as many
    more as take MIN_TIMED_MS (the caller has called fn once already: the
    warm-up)."""
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(stop)
        if total >= MIN_TIMED_MS or reps >= 1000:
            return total / reps
        reps = min(1000, int(reps * MIN_TIMED_MS / max(total, 1e-3)) + 1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return card


def phase_build() -> None:
    from labrador_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    loaded = cuda_lib.load()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(library {cuda_lib.source_hash()})")
    kernel = ""
    for line in loaded.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        if "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")


def _kernel_name(line: str) -> str:
    """The kernel's name and first template argument in a ptxas line, out
    of the mangled name (a length-prefixed identifier ending in kernel)."""
    for m in re.finditer(r"\d+", line):
        end = m.end() + int(m[0])
        if line[m.end():end].endswith("kernel"):
            arg = re.match(r"ILi(\d+)E", line[end:])
            return line[m.end():end] + (f"<{arg[1]}>" if arg else "")
    return ""


def phase_table() -> dict:
    """Every row of the case table, timed; returns the kernel table's
    rows by kernel name, each from the kernel's first row."""
    table = {}
    for row in cases.ROWS:
        case = row.make("cuda")
        row.info.launches = 0
        got = case.kernel()
        torch.cuda.synchronize()
        launches = row.info.launches
        want = case.plain()
        also = {name: call() for name, call in case.also.items()}
        torch.cuda.synchronize()
        err = 0
        for name, out in [("plain", want)] + list(also.items()):
            if out.shape != got.shape:
                raise AssertionError(f"{row.id}: {name} shape {out.shape}")
            err = max(err, int(torch.max(torch.abs(out - got))))
        if err or launches != row.launches:
            raise AssertionError(f"{row.id}: max abs error {err}, "
                                 f"{launches} launches")
        ms = cuda_ms(case.kernel, KERNEL_REPS)
        plain_ms = cuda_ms(case.plain, PLAIN_REPS)
        also_ms = {name: cuda_ms(call, ALSO_REPS)
                   for name, call in case.also.items()}
        bound_ms, bound_by = case.cost.bound()
        log(f"{row.id:40s} {str(tuple(got.shape)):18s} kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  "
            + "".join(f"{k} {v:.4f} ms  " for k, v in also_ms.items())
            + f"{launches} launch(es) of {row.info.name}; "
            f"{case.cost.describe()}; at {bound_ms / ms:.1%} of the bound")
        if row.info.name not in table:
            table[row.info.name] = {
                "name": row.info.name, "route": "cuda",
                "source": row.info.source, "replaces": row.info.replaces,
                "row": row.id, "launches_a_call": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": also_ms.get("library")}
        del case, got, want, also
    torch.cuda.empty_cache()
    missing = [k.name for k in cases.kernel_infos() if k.name not in table]
    if missing:
        raise AssertionError(f"no row times {missing}")
    log(f"{len(cases.ROWS)} rows timed")
    return table


def sharded_world() -> dict:
    """The 4-rank world on cuda:0, every run checked; returns the ranks'
    launches (their own processes) summed by kernel name."""
    import test_torch_sharded as sharded
    with tempfile.TemporaryDirectory() as store:
        refs, ranks = sharded.card_world(store)
    launches: dict = {}
    for run in sharded.CARD_RUNS:
        sharded.check_card_run(refs, ranks, run)
        for out in ranks:
            for k, n in out.get(run, {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
    return launches


def bench() -> None:
    """The port's bench at config 1 (its batch of 16 proves and verifies,
    the verify profile and the phases), in its own process; its stdout's
    one JSON line is printed here, its stderr's lines after it.  Its
    launches are its process's and are not counted."""
    proc = subprocess.run(
        [sys.executable, "-m", "labrador_tpu_torch.bench", "--batch-prove",
         "16", "--batch-verify", "16", "--verify-profile", "--phases"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[0]) if len(lines) == 1 else {}
    if sorted(line) != ["metric", "unit", "value", "vs_baseline"] \
            or not line["value"] > 0:
        raise AssertionError(f"bench printed {lines}")
    log(json.dumps(line))
    for err_line in proc.stderr.strip().splitlines():
        log(f"bench: {err_line}")


def phase_paths() -> dict:
    """Every path, its launches counted from zero; returns the launches
    of all paths by kernel name."""
    paths = ([(f"config1 {n}", lambda n=n: cases.golden_flow(n))
              for n in cases.GOLDEN_FLOWS]
             + [(f"2^14 {n}", fn) for n, fn in cases.FLOWS_2P14.items()]
             + [("sharded world", sharded_world), ("bench", bench)])
    infos = cases.kernel_infos()
    total = {k.name: 0 for k in infos}
    for label, run in paths:
        for k in infos:
            k.launches = 0
        t0 = time.perf_counter()
        elsewhere = run() or {}
        torch.cuda.synchronize()
        counts = {k.name: k.launches + elsewhere.get(k.name, 0)
                  for k in infos}
        for name, n in counts.items():
            total[name] += n
        log(f"path {label}: passed in {time.perf_counter() - t0:.2f} s "
            f"(host clock); launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        torch.cuda.empty_cache()
    return total


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    table = phase_table()
    launches = phase_paths()
    log(f"chip_smoke: {time.perf_counter() - t0:.2f} s on {card}, the "
        f"kernels' build included")
    rows = [{**table[k.name], "launches": launches[k.name]}
            for k in cases.kernel_infos()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

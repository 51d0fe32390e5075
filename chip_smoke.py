"""Smoke run of the PyTorch + CUDA port on one GPU: builds the commitment
kernels, holds each against its plain PyTorch version, proves and verifies
config 1 against the JAX package's golden transcript, then proves and
verifies the 2^14-coefficient instance (BASELINE.json config 3).

Usage (from the repository root, on a machine with one CUDA card):
    python3 chip_smoke.py

Every phase raises on failure, so the script exits non-zero; without a
CUDA device it exits non-zero before printing any result.  The last line
of standard output is the result JSON; the line before it lists each
kernel with its launches in the 2^14 run and its time beside the plain
version's.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "config1.json"
REAL = dict(n=16, r=16, kappa=256)       # BASELINE.json config 3
TIMED_RUNS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    for line in loaded.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _kernel_cases(n: int, r: int, kappa: int, seed: int):
    """(kernel module, label, kernel fn, plain fn) at one instance's shapes,
    on inputs from a fixed numpy seed."""
    from labrador_tpu_torch.crs import CRS
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    from labrador_tpu_torch.params import LabradorParams
    from labrador_tpu_torch.protocol import _tri_stream

    p = LabradorParams(n=n, r=r, kappa_override=kappa)
    crs = CRS.create(p, seed=0xC0FFEE + seed)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    def digits(base: int, shape):
        return t(rng.integers(-(base // 2), base // 2 + 1, shape) % p.q)

    w = t(rng.integers(0, p.q, (p.r, p.n, p.d)))
    t_dig = digits(p.b_1, (p.t_1, p.r, p.kappa, p.d))
    g_str = _tri_stream(digits(p.b_2, (p.t_2, p.r, p.r, p.d)), p)
    h_str = _tri_stream(digits(p.b_1, (p.t_1, p.r, p.r, p.d)), p)
    return [
        (ajtai_cuda, "ajtai r_eff=r",
         lambda: ajtai_cuda.ajtai_commit(crs, w),
         lambda: ajtai_cuda.ajtai_commit_plain(crs, w)),
        (ajtai_cuda, "ajtai r_eff=1",
         lambda: ajtai_cuda.ajtai_commit(crs, w[:1]),
         lambda: ajtai_cuda.ajtai_commit_plain(crs, w[:1])),
        (u1_cuda, "u1 B-term",
         lambda: u1_cuda.u1_bterm(crs, t_dig),
         lambda: u1_cuda.u1_bterm_plain(crs, t_dig)),
        (cd_cuda, "cd D-term (u2)",
         lambda: cd_cuda.cd_sum(crs, h_str, crs._off_d, p.t_1),
         lambda: cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1)),
        (cd_cuda, "cd C-term (u1)",
         lambda: cd_cuda.cd_sum(crs, g_str, crs._off_c, p.t_2),
         lambda: cd_cuda.cd_sum_plain(crs, g_str, crs._off_c, p.t_2)),
    ]


def phase_kernels() -> dict:
    """Each kernel against its plain version at the config-1 and the 2^14
    shapes; bit-equality required.  Returns per-kernel error and the times
    of its first case at the 2^14 shapes (Ajtai at r_eff = r, the u1
    B-term, the u2 D-term)."""
    stats: dict = {}
    for label_size, shape in (("config1", dict(n=2, r=2, kappa=0)),
                              ("2^14", REAL)):
        for mod, label, kern, plain in _kernel_cases(**shape, seed=7):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int(torch.max(torch.abs(got - want)))
            if got.shape != want.shape or err != 0:
                raise AssertionError(f"{label} at {label_size}: kernel != "
                                     f"plain (max abs err {err})")
            ms = cuda_ms(kern, 10)
            plain_ms = cuda_ms(plain, 2)
            log(f"kernel {label:16s} {label_size:7s} {str(tuple(got.shape)):15s}"
                f" bit-equal (tolerance 0)  kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms")
            st = stats.setdefault(mod.KERNEL.name, {"max_abs_err": 0})
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if label_size == "2^14" and "ms" not in st:
                st["ms"], st["plain_ms"] = ms, plain_ms
    return stats


def _kernels():
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    return [ajtai_cuda.KERNEL, u1_cuda.KERNEL, cd_cuda.KERNEL]


def _reset_counts() -> None:
    for k in _kernels():
        k.launches = 0


def _counts() -> dict:
    return {k.name: k.launches for k in _kernels()}


def phase_config1() -> None:
    """Config 1 on cuda: transcript digest, sizes and report equal the JAX
    package's golden values; tampered z fails check 15; every kernel
    launches in prove and in verify."""
    from labrador_tpu_torch import keys, prover, structs, verifier
    from labrador_tpu_torch.cli import run_flow

    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    res = run_flow(cfg["n"], cfg["r"], cfg["kappa"], cfg["seed"], "cuda")
    p, proof = res.params, res.proof
    digest = structs.transcript_sha256(proof, p.q)
    if digest != golden["transcript_sha256"]:
        raise AssertionError(f"config-1 transcript digest {digest} != JAX "
                             f"golden {golden['transcript_sha256']}")
    sizes = [structs.transcript_size_in_bytes(proof, p.q),
             structs.transcript_size_in_bytes(proof, p.q, fs=True)]
    if sizes != [golden["transcript_size_in_bytes"],
                 golden["transcript_size_in_bytes_fs"]]:
        raise AssertionError(f"config-1 sizes {sizes} != golden")
    if res.report != golden["verify_report"] or not all(res.report.values()):
        raise AssertionError(f"config-1 report {res.report}")
    bad_z = proof.z.clone()
    bad_z[0, 3] = (bad_z[0, 3] + 1) % p.q
    rep_bad = verifier.verify_report(p, res.state, proof.replace(z=bad_z),
                                     res.crs)
    if rep_bad["c15_az_vs_ct"] or rep_bad["all"]:
        raise AssertionError("tampered z was not rejected by check 15")

    kv = keys.split(keys.key(cfg["seed"]), 3)[2]
    _reset_counts()
    prover.prove(p, res.witness, res.state, res.crs, kv)
    in_prove = _counts()
    _reset_counts()
    verifier.verify_report(p, res.state, proof, res.crs)
    in_verify = _counts()
    torch.cuda.synchronize()
    if not all(in_prove.values()) or not all(in_verify.values()):
        raise AssertionError(f"kernel not launched: prove {in_prove}, "
                             f"verify {in_verify}")
    log(f"config1: transcript sha256 {digest} == JAX golden; size "
        f"{sizes[0]} B (fs {sizes[1]} B) == golden; all checks true; "
        f"tampered z rejected (c15)")
    log(f"config1: launches in prove {in_prove}, in verify {in_verify}")
    prove_s, verify_s = _timed_runs(dict(n=cfg["n"], r=cfg["r"],
                                         kappa=cfg["kappa"]))
    log(f"config1: prove {prove_s * 1e3:.2f} ms, verify {verify_s * 1e3:.2f} "
        f"ms (median of {TIMED_RUNS} after one warm-up, host clock after "
        f"sync); first run prove {res.prove_s * 1e3:.2f} ms verify "
        f"{res.verify_s * 1e3:.2f} ms")


def _timed_runs(shape: dict) -> tuple[float, float]:
    """Median prove and verify seconds of TIMED_RUNS further runs."""
    from labrador_tpu_torch.cli import run_flow
    runs = [run_flow(**shape, seed=42, device="cuda")
            for _ in range(TIMED_RUNS)]
    return (statistics.median(r.prove_s for r in runs),
            statistics.median(r.verify_s for r in runs))


def phase_real() -> dict:
    """The 2^14 instance end to end; returns the launches of its first
    (counted) run."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    _reset_counts()
    res = run_flow(**REAL, seed=42, device="cuda")
    launches = _counts()
    p = res.params
    if not (bool(res.proof.jl_ok) and bool(res.proof.b_pp_ok)):
        raise AssertionError("2^14 prover self-checks failed")
    if not all(res.report.values()):
        failed = [k for k, v in res.report.items() if not v]
        raise AssertionError(f"2^14 verification failed: {failed}")
    for name in ("u_1", "u_2", "t", "z"):
        x = getattr(res.proof, name)
        if not bool(torch.all((x >= 0) & (x < p.q))):
            raise AssertionError(f"2^14 transcript field {name} out of range")
    prove_s, verify_s = _timed_runs(REAL)
    size = structs.transcript_size_in_bytes(res.proof, p.q)
    size_fs = structs.transcript_size_in_bytes(res.proof, p.q, fs=True)
    log(f"2^14 ({' '.join(f'{k}={v}' for k, v in REAL.items())}): all "
        f"checks true; launches {launches}")
    log(f"2^14: prove {prove_s * 1e3:.2f} ms, verify {verify_s * 1e3:.2f} "
        f"ms (median of {TIMED_RUNS} after one warm-up, host clock after "
        f"sync); first run "
        f"prove {res.prove_s * 1e3:.2f} ms verify {res.verify_s * 1e3:.2f} ms")
    log(f"2^14: proof {size} B = {size / 1024:.2f} KB (fs metric {size_fs} B)")
    return launches


def main() -> int:
    phase_device()
    phase_build()
    stats = phase_kernels()
    phase_config1()
    launches = phase_real()
    rows = []
    for k in _kernels():
        st = stats[k.name]
        if not launches[k.name]:
            raise AssertionError(f"{k.name} never launched on the main path")
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                     "plain_ms": st["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

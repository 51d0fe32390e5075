"""The port's benchmark entry point (``labrador_tpu_torch/bench.py``) on
the CPU, with no JAX: the one JSON line of ``--cpu --quick``, the e2e
proof verifying, positive batch rates at B = 2, the per-check and
per-phase timings, the roofline guard refusing an impossible rate, and a
run without ``--cpu`` on a machine without a card failing instead of
falling back to the CPU.  The flows run at kappa = 32 (the functions'
override) where the defaults' kappa = 128 would spend seconds a prove in
the plain u1 B-term."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from labrador_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent
CPU = dict(device="cpu", kappa=32)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the flows are many small torch ops, which
    stall on the other test processes' threads when the suite runs in
    parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cpu_quick_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "labrador_tpu_torch.bench", "--cpu",
         "--quick"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "rq_ntt_polymul_ops_per_s"
    assert line["unit"] == "ops/s" and line["value"] > 0
    assert line["vs_baseline"] > 0
    assert proc.stderr.startswith("device: cpu")


def test_e2e_proof_verifies():
    """bench_e2e raises unless its first proof verifies."""
    out = bench.bench_e2e(iters=1, **CPU)
    assert out["prove_s"] > 0 and out["verify_s"] > 0
    assert out["proof_kb"] > 0


@pytest.mark.parametrize("fn", [bench.bench_batch_prove,
                                bench.bench_batch_verify])
def test_batch_rates_positive(fn):
    assert fn(batch=2, iters=1, **CPU) > 0


def test_verify_profile_and_phases():
    prof = bench.bench_verify_profile(**CPU)
    assert {"c15_az_vs_ct", "c19_u1", "c20_u2", "all"} <= set(prof)
    assert all(v > 0 for v in prof.values())
    assert prof["all"] >= prof["c19_u1"]
    phases = bench.bench_phases(iters=1, **CPU)
    assert set(phases) == {"p1_commitments", "p2_jl_aggregation_u2",
                           "p3_opening"}


def test_roofline_guard_refuses(monkeypatch):
    """A clock that sees no time pass gives a rate above the card's bound:
    refused, not reported."""
    ticks = iter(range(10**6))
    monkeypatch.setattr(bench, "_clock", lambda: next(ticks) * 1e-12)
    with pytest.raises(RuntimeError, match="refusing"):
        bench.bench_polymul(batch=64, scan_len=1, iters=1, device="cpu")


def test_no_card_no_fallback(monkeypatch, capsys):
    """Without --cpu the card is required: with none, main fails and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--quick"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err

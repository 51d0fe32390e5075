"""A whole run of each cell on the CPU at a small size, the faults that
must make ``correct`` false, the trace reader, and the command's refusals.
"""

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

import perfbench_helpers as H
from perfbench.lib import roofline, runner, spec, trace, window
from perfbench import run as run_mod

CELLS = ["2p14-bigq.fs", "2p20-bigq.interactive"]


def _run(cell, traced=False, seconds=1.5):
    return runner.run_cell(cell, 2**31 + 11, seconds, traced, "cpu",
                           time.time())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_is_correct_and_reports_its_metrics(workload, traced):
    cell = H.small_cell(workload, check_sample=2, trace_steps=2)
    result, info, checks = _run(cell, traced)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 2
    assert list(result)[-1] == "checks"
    assert len(checks) == len(result["checks"])
    if traced:
        names = {m["name"] for m in cell.per_layer}
        # no device on the CPU: the device-trace metrics are left out
        assert set(result["metrics"]) == names - {
            "kernels.u1_roofline_pct", "kernels.cd_roofline_pct",
            "device.idle_pct"}
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("fault", ["stale_proof", "altered_z",
                                   "accepts_all"])
def test_faults_make_correct_false(fault, monkeypatch):
    from labrador_tpu_torch import prover, verifier
    real_fs = prover.prove_fs
    first = {}
    if fault == "stale_proof":
        monkeypatch.setattr(prover, "prove_fs", lambda *a, **k:
                            first.setdefault("p", real_fs(*a, **k)))
    elif fault == "altered_z":
        def altered(*a, **k):
            tr = real_fs(*a, **k)
            z = tr.z.clone()
            z[0, 0] = (z[0, 0] + 1) % a[0].q
            return dataclasses.replace(tr, z=z)
        monkeypatch.setattr(prover, "prove_fs", altered)
    else:
        monkeypatch.setattr(verifier, "verify_fs", lambda *a, **k: True)
    cell = H.small_cell("2p14-bigq.fs", check_sample=3, pool=3)
    result, _, _ = _run(cell)
    assert not result["correct"]


def test_interactive_stale_proof_is_caught(monkeypatch):
    from labrador_tpu_torch import prover
    real = prover.prove
    first = {}
    monkeypatch.setattr(prover, "prove", lambda *a, **k:
                        first.setdefault("p", real(*a, **k)))
    cell = H.small_cell("2p20-bigq.interactive", check_sample=2)
    result, _, _ = _run(cell)
    assert not result["correct"]
    assert result["checks"]["fields_differing"]["value"] > 0


def test_trace_busy_idle_and_gap_names():
    t = trace.Trace(
        device=[("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("memset", 6.0, 7.0)],
        spans=[("step.prove", 0.0, 8.0), ("prover.phase2a", 3.0, 5.0)],
        start=0.0, end=8.0)
    assert t.busy_intervals() == [[1.0, 3.0], [6.0, 7.0]]
    assert t.busy_s == 3.0 and t.window_s == 8.0
    assert t.idle_gaps() == [["prover.phase2a", 3.0], ["step.prove", 2.0]]
    assert t.top_ops()[0] == ["k2", 1.5]


def test_stream_kernels_take_their_split_reduction():
    dev = [("void mma_stream_kernel<5, 3, (anon)::U1Offset, T>(long*)", 0, 2),
           ("void reduce_splits_kernel(long const*)", 2, 2.5),
           ("void mma_stream_kernel<5, 3, (anon)::CdOffset, T>(long*)", 3, 4),
           ("void reduce_splits_kernel(long const*)", 4, 4.25),
           ("elementwise", 5, 6)]
    t = trace.Trace(dev, [], 0.0, 6.0)
    assert roofline.stream_kernel_s(t, "U1Offset") == 2.5
    assert roofline.stream_kernel_s(t, "CdOffset") == 1.25
    assert trace.short_name(dev[0][0]) == \
        "void mma_stream_kernel<5, 3, (anon)::U1Offset, T>"


def test_percentile_and_end_to_end_by_name():
    rec = window.Record(prove_s=[0.001 * i for i in range(1, 101)],
                        verify_s=[0.002] * 100)
    assert window.nearest_rank(rec.prove_s, 95) == pytest.approx(0.095)
    assert window.end_to_end("prove_p95_ms", rec, 1.0) == pytest.approx(95)
    assert window.end_to_end("verify_ms", rec, 1.0) == pytest.approx(2)
    assert window.end_to_end("setup_s", rec, 1.5) == 1.5
    with pytest.raises(KeyError):
        window.end_to_end("nothing_ms", rec, 1.0)


def test_command_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "2p14-bigq.fs", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_command_outside_a_checkout_of_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: no result."""
    import shutil
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "2p14-bigq.fs", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "labrador_tpu_torch.x", object())
    assert "labrador_tpu" not in run_mod.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "labrador_tpu.ops", object())
    assert "labrador_tpu" in run_mod.loaded_forbidden()


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    cell = H.small_cell("2p14-bigq.fs", check_sample=2, trace_steps=2)
    result, _, _ = runner.run_cell(cell, 2**31 + 13, 2.0, True,
                                   cuda_device, time.time())
    assert result["correct"]
    assert result["device"]["busy_s"] > 0
    json.dumps(result)


def test_a_rejection_the_reference_shares_is_not_a_fault(monkeypatch):
    """A verdict that rejects an honest proof counts as failed; it is a
    fault only where the reference does not make the same proof and the
    same verdict."""
    from labrador_tpu_torch import verifier
    from perfbench.reference import verifier as ref_verifier
    monkeypatch.setattr(verifier, "verify_fs", lambda *a, **k: False)
    monkeypatch.setattr(ref_verifier, "verify_fs", lambda *a, **k: False)
    monkeypatch.setattr(window, "REJECTED_KEPT", 1000)
    cell = H.small_cell("2p14-bigq.fs", check_sample=1, pool=2)
    result, info, _ = _run(cell, seconds=0.5)
    assert result["failed"] == result["attempted"] > 0
    assert result["checks"]["rejections_differing"]["value"] == 0
    assert result["checks"]["tampered_verdicts_differing"]["value"] == 0
    assert any(line.startswith("rejected steps: [[0, [\"verify_fs\"]]")
               for line in info)


def test_rejections_beyond_the_kept_proofs_count(monkeypatch):
    """Interactive proofs differ step by step (a fresh verifier key):
    each rejection beyond the kept proofs counts as differing."""
    from labrador_tpu_torch import verifier
    from perfbench.reference import verifier as ref_verifier
    monkeypatch.setattr(verifier, "verify_report",
                        lambda *a, **k: {"all": False})
    monkeypatch.setattr(ref_verifier, "verify_report",
                        lambda *a, **k: {"all": False})
    monkeypatch.setattr(window, "REJECTED_KEPT", 1)
    cell = H.small_cell("2p20-bigq.interactive", check_sample=1, pool=1)
    result, _, _ = _run(cell, seconds=1.5)
    assert result["failed"] >= 2
    assert result["checks"]["rejections_differing"]["value"] == \
        result["failed"] - 1
    assert not result["correct"]


def test_a_repeated_rejected_proof_is_judged_with_the_kept_one(
        monkeypatch):
    """A Fiat-Shamir proof repeats on every step of its statement: a
    statement whose honest proof is rejected fails each of its steps, and
    every repeat is judged with the one kept proof."""
    from labrador_tpu_torch import verifier
    from perfbench.reference import verifier as ref_verifier
    monkeypatch.setattr(verifier, "verify_fs", lambda *a, **k: False)
    monkeypatch.setattr(ref_verifier, "verify_fs", lambda *a, **k: False)
    monkeypatch.setattr(window, "REJECTED_KEPT", 2)
    cell = H.small_cell("2p14-bigq.fs", check_sample=1, pool=2)
    result, _, _ = _run(cell, seconds=1.5)
    assert result["failed"] >= 3
    assert result["checks"]["rejections_differing"]["value"] == 0
    assert result["correct"]


def test_a_new_mix_and_protocol_run_as_files_alone(tmp_path):
    """A mix file and a protocol module dropped into a copy of the
    benchmark's directory give a whole run, judged by the reference, with
    no file of the harness edited."""
    import shutil
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(H.ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    H.dump(bench_dir / "traffic" / "odd.json",
           {"protocol": "fs_odd", "pool": 3, "check_sample": 2,
            "trace_steps": 1})
    (bench_dir / "protocols" / "fs_odd.py").write_text(
        "from perfbench.lib import spec\n"
        "fs = spec.load_protocol('fs')\n\n\n"
        "class Odd(fs.FiatShamir):\n"
        "    def statement(self, step):\n"
        "        return (2 * step + 1) % len(self.states)\n\n\n"
        "make = Odd\n")
    cell = H.small_cell("2p14-bigq.fs")
    cell.traffic = spec.load_traffic("odd", bench_dir)
    result, _, _ = runner.run_cell(cell, 2**31 + 17, 1.0, False, "cpu",
                                   time.time(), bench_dir)
    assert result["correct"] and result["attempted"] >= 1


def test_probes_of_one_target_must_agree():
    a = {"target": "m.f", "span": "x"}
    assert len(window.probes_of([a, dict(a)])) == 1
    with pytest.raises(ValueError):
        window.probes_of([a, {"target": "m.f", "span": "y"}])

"""The port's benchmark scripts (``labrador_tpu_torch/benchmarks/``) run
on the CPU at a tiny size, in-process, and print one JSON line per row
with the expected keys.  ``proof_size_parity`` runs at its own size
(config 1 on the reference's ChaCha CRS) and must print delta_bytes 0.
``sharded_scaling`` has its own test (``tests/test_torch_sharded.py``
runs its worlds).  No JAX."""

import importlib
import json

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = {
    "proof_size_parity": ([], {"framework_gzip_bincode_bytes",
                               "refsim_gzip_bincode_bytes", "delta_bytes",
                               "config", "device"}),
    "recursion_size": (["--n", "2", "--r", "2", "--kappa", "16", "--mu",
                        "4", "--kappa-new", "16", "--fs-size-only"],
                       {"level", "n", "r", "prove_ms", "fs_proof_bytes",
                        "device"}),
    "scaling": (["--min-pow", "8", "--max-pow", "8", "--iters", "1"],
                {"witness_coeffs", "n", "r", "kappa", "q", "prove_ms",
                 "verify_ms", "proof_bytes", "verified", "first_run_ms",
                 "device"}),
    "ajtai_bench": (["--kappa", "16", "--n", "2", "--r", "2", "--iters",
                     "2"], {"kernel", "bit_equal", "kernel_ms", "plain_ms",
                            "device"}),
    "cd_bench": (["--kappa", "16", "--n", "2", "--r", "4", "--iters", "2"],
                 {"kernel", "bit_equal", "kernel_ms", "plain_ms", "L",
                  "device"}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_benchmark_runs_on_cpu(name, capsys):
    argv, want = CASES[name]
    mod = importlib.import_module(f"labrador_tpu_torch.benchmarks.{name}")
    mod.main(argv + ["--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert rows
    for row in rows:
        assert row["device"] == "cpu"
        assert want <= set(row) or row.get("level", -1) == 0, row
    if name == "proof_size_parity":
        assert rows[0]["delta_bytes"] == 0
        assert rows[0]["framework_gzip_bincode_bytes"] == 119269
    if name == "recursion_size":
        assert [r["level"] for r in rows] == [0, 1]
        assert rows[1]["verified"] and rows[1]["mu"] == 4
    if name == "scaling":
        assert rows[0]["verified"] and rows[0]["witness_coeffs"] == 256
    if name in ("ajtai_bench", "cd_bench"):
        assert all(r["bit_equal"] for r in rows)


def test_benchmark_refuses_cuda_without_a_card(monkeypatch):
    """--device cuda (the default) on a machine without a card stops
    before any work."""
    from labrador_tpu_torch.benchmarks import cd_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cd_bench.main([])

"""BENCHMARK.json against the benchmark's contract, and the harness's
lookups by name."""

import json
import re

import pytest

import perfbench_helpers as H
from perfbench.lib import spec

BENCH_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
              "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_parses_with_the_contract_keys():
    b = H.bench()
    assert set(b) == BENCH_KEYS
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert all(PATH_RE.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == CONFIG_KEYS
    for w in b["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len((H.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines_are_well_formed():
    b = H.bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME_RE.match(n), n
    for w in b["workloads"]:
        assert spec.NAME_RE.match(w["config"])
        assert spec.NAME_RE.match(w["traffic"])
        assert _line(w["why"])
    for c in b["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in b["per_layer"]:
        assert _line(m["layer"])
    for word in b["command"]:
        assert _line(word)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    b = H.bench()
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if spec.applies(m, w["name"])]
        layer = [m for m in b["per_layer"] if spec.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_moves_names_an_e2e_metric_that_all_its_cells_report():
    b = H.bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert spec.applies(target, cell), (m["name"], cell)


def test_metrics_of_one_layer_share_its_name_and_layers_are_known():
    b = H.bench()
    assert {m["layer"] for m in b["per_layer"]} == {
        "prover", "verifier", "kernels", "device"}
    for m in b["per_layer"]:
        assert m["name"].split(".")[0] == m["layer"]


def test_configs_mixes_and_metrics_are_found_by_name():
    b = H.bench()
    configs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert configs == used
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        cfg = json.loads((H.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = spec.resolve(b, H.ROOT, w["name"])
        proto = spec.load_protocol(cell.traffic["protocol"])
        assert callable(proto.make)
    for m in b["per_layer"]:
        reader = spec.load_reader(m["name"])
        assert callable(reader.read)
    with pytest.raises(KeyError):
        spec.resolve(b, H.ROOT, "no-such-cell")


def test_a_new_config_mix_and_metric_are_picked_up_without_an_edit(
        tmp_path):
    """A cell that a later change adds is data: a configuration file, a
    mix file and a reader, found by the names of its entries."""
    bench_dir = tmp_path / "perfbench"
    H.dump(bench_dir / "configs" / "tiny.json",
           {"name": "tiny", "reduced": [], **H.params(16)})
    H.dump(bench_dir / "traffic" / "burst.json",
           {"protocol": "echo", "pool": 3, "check_sample": 1,
            "trace_steps": 1})
    (bench_dir / "protocols").mkdir()
    (bench_dir / "protocols" / "echo.py").write_text(
        "def make(config, mix, seed, device):\n"
        "    return ('echo', mix['pool'], seed)\n")
    (bench_dir / "metrics").mkdir()
    (bench_dir / "metrics" / "prover.new_ms.py").write_text(
        "PROBES = []\n\ndef read(rec):\n    return 1.0\n")
    b = {"configs": [{"name": "tiny", "file": "perfbench/configs/tiny.json",
                      "source": "https://example.org", "reduced": [],
                      "why": "x"}],
         "workloads": [{"name": "tiny.burst", "config": "tiny",
                        "traffic": "burst", "chips": 1, "why": "x"}],
         "end_to_end": [{"name": "prove_ms", "unit": "ms", "bound": 0.05,
                         "better": "lower", "source": "host_clock"}],
         "per_layer": [{"name": "prover.new_ms", "unit": "ms",
                        "better": "lower", "source": "host_clock",
                        "layer": "prover", "moves": "prove_ms"}]}
    cell = spec.resolve(b, tmp_path, "tiny.burst", bench_dir)
    assert cell.config["params"]["kappa_override"] == 16
    assert cell.traffic["pool"] == 3
    assert [m["name"] for m in cell.per_layer] == ["prover.new_ms"]
    assert spec.load_reader("prover.new_ms", bench_dir).read(None) == 1.0
    assert spec.make_traffic(cell, 9, "cpu", bench_dir) == ("echo", 3, 9)


def test_run_seconds_fits_the_full_check_with_24_cells():
    rs = H.bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_state_the_derived_parameters_both_sides_derive():
    from labrador_tpu_torch.params import LabradorParams
    from perfbench.lib.proofs import derived_mismatch
    from perfbench.reference.params import LabradorParams as RefParams
    for c in H.bench()["configs"]:
        cfg = json.loads((H.ROOT / c["file"]).read_text())
        for cls in (LabradorParams, RefParams):
            assert derived_mismatch(cls(**cfg["params"]),
                                    cfg["derived"]) == {}

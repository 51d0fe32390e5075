"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose file lies where
its ``file`` says, and a traffic mix, read from ``traffic/<mix>.json``.
A mix names its protocol, the module ``protocols/<protocol>.py`` that
makes the cell's statements and runs its step (``lib/proofs``).  A
per-layer metric's reader is ``metrics/<name>.py``.  A later change adds
files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    """One workload of a benchmark, with everything it names resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    """A metric without ``workloads`` is reported in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench: dict, root: Path, workload: str,
            bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` (a parsed ``BENCHMARK.json``
    whose paths are relative to ``root``); raises KeyError for a name the
    benchmark does not hold."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=load_traffic(w["traffic"], bench_dir),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, workload)])


def load_traffic(mix: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{mix}.json") as f:
        return json.load(f)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``metrics/<metric>.py``: ``PROBES``, the program's
    functions its spans need, and ``read(rec)``."""
    return _load(bench_dir / "metrics" / f"{metric}.py", "metric", metric)


def load_protocol(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``protocols/<name>.py``: ``make(config, mix, seed,
    device)`` gives a cell's traffic (``lib/proofs``)."""
    return _load(bench_dir / "protocols" / f"{name}.py", "protocol", name)


def make_traffic(cell: Cell, seed: int, device,
                 bench_dir: Path = BENCH_DIR):
    """The traffic of ``cell`` from ``seed``, on ``device``."""
    proto = load_protocol(cell.traffic["protocol"], bench_dir)
    return proto.make(cell.config, cell.traffic, seed, device)


def _load(path: Path, kind: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

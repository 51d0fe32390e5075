"""Small cells for the CPU tests: the benchmark's cells with their
configuration cut to a test's size."""

import json

from perfbench.lib import spec

ROOT = spec.BENCH_DIR.parent


def params(kappa: int) -> dict:
    """Config 1's shape (n = r = 2) at the big modulus, kappa as given."""
    return {"params": dict(n=2, r=2, kappa_override=kappa,
                           exact_digits=True, q_start=(1 << 32) - 1)}


def bench() -> dict:
    return spec.load_benchmark(ROOT / "BENCHMARK.json")


def small_cell(workload: str, kappa: int = 16, **mix) -> spec.Cell:
    """``workload`` of BENCHMARK.json at the small configuration, its mix
    with ``mix``'s keys replaced."""
    cell = spec.resolve(bench(), ROOT, workload)
    cell.config = params(kappa)
    cell.traffic = {**cell.traffic, **mix}
    return cell


def dump(path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))

"""The plain reference against the program on the CPU, the control, and
what the benchmark may import."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import perfbench_helpers as H
from perfbench import control
from perfbench.lib import correct, spec
from perfbench.lib.proofs import differing_fields

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "labrador_tpu"}


@pytest.fixture(scope="module", params=["fs", "interactive"])
def cell_1(request):
    """Config 1's size (n = r = 2, kappa = 128) at the big modulus."""
    workload = {"fs": "2p14-bigq.fs",
                "interactive": "2p20-bigq.interactive"}[request.param]
    return H.small_cell(workload, kappa=128, pool=2)


def test_reference_equals_the_program_and_judges_alike(cell_1):
    traffic = spec.make_traffic(cell_1, 2**31 + 99, "cpu")
    for step in range(2):
        proof = traffic.prove(step)
        ref = traffic.reference_prove(step)
        assert differing_fields(proof, ref) == []
        answer = traffic.verify(step, proof)
        assert traffic.accepted(answer)
        assert traffic.reference_verify(step, proof) == answer
    assert traffic.bincode(proof) == traffic.reference_bincode(ref)
    bad = traffic.tampered(proof)
    assert not traffic.accepted(traffic.verify(step, bad))
    assert not traffic.accepted(traffic.reference_verify(step, bad))


@pytest.mark.parametrize("workload", ["2p14-bigq.fs",
                                      "2p20-bigq.interactive"])
def test_control_in_lower_precision_comes_out_not_correct(workload):
    cell = H.small_cell(workload, check_sample=2, pool=2)
    program = control.readings(cell, 2**31 + 5, False, "cpu")
    ctrl = control.readings(cell, 2**31 + 5, True, "cpu")
    assert correct.within(program)
    assert not correct.within(ctrl)
    assert ctrl["fields_differing"] >= 3


def test_a_differing_field_is_seen():
    cell = H.small_cell("2p14-bigq.fs")
    traffic = spec.make_traffic(cell, 7, "cpu")
    proof = traffic.prove(0)
    z = proof.z.clone()
    z[0, 0] += 1
    assert differing_fields(proof, dataclasses.replace(proof, z=z)) == ["z"]
    wide = dataclasses.replace(proof, z=proof.z.to(torch.int32))
    assert differing_fields(proof, wide) == ["z"]


@pytest.mark.parametrize("workload", ["2p14-bigq.fs",
                                      "2p20-bigq.interactive"])
def test_statements_are_the_program_generators_draws(workload):
    """Each witness of the pool is the program's
    ``sampling.generate_witness`` draw as it stands, with no further
    halving."""
    from labrador_tpu_torch import keys, sampling
    cell = H.small_cell(workload, pool=3)
    traffic = spec.make_traffic(cell, 2**31 + 41, "cpu")
    kw = keys.split(keys.key(2**31 + 41), 3)[0]
    for i, w in enumerate(traffic.pool.witnesses):
        assert torch.equal(w, sampling.generate_witness(
            keys.fold_in(kw, i), traffic.params, "cpu"))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: labrador_tpu_torch is the program,
    labrador_tpu the JAX package."""
    files = list(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for m in (BENCH / "metrics").glob("*.py"):
        src = m.read_text()
        for t in ("labrador_tpu.", "jax"):
            assert f'"{t}' not in src and f"'{t}" not in src


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert "labrador_tpu_torch" not in _imports(f), f
        assert not (_imports(f) & FORBIDDEN), f


def test_the_program_imports_no_jax():
    pkg = BENCH.parent / "labrador_tpu_torch"
    for f in pkg.rglob("*.py"):
        assert not (_imports(f) & FORBIDDEN), f

"""Two levels of recursion in the port, held against the JAX package.

The size is tests/test_recursion.py's (n = 2, r = 2, kappa = 16, exact
digits, seed 31337, CRS seed 0xEC): the base proof is folded (level 1:
the CLI's mu, CRS seed 0x5EC0, key 99), proved and verified, and that
proof is folded again (level 2: mu = 6, CRS seed 0x5EC2, key 7), proved
and verified.  ``labrador_tpu_torch/golden/two_level.json`` records, for
the base and each level, the parameters, the transcript SHA-256 of the
bincode stream, ``transcript_size_in_bytes_fs``, the folded residual and
the verify report, as the JAX package's flow gives them.

The Tier-1 test runs the port's two levels on the CPU against the file.
The test that regenerates the file from the JAX package is marked
``slow`` (it compiles the level-2 programs, many minutes on the CPU) and
runs the JAX flow in a subprocess, as tests/test_recursion.py does,
because XLA segfaults on those programs mid-suite.  Regenerate with

    python tests/test_torch_two_level.py --write

The file holds the flow at q = 8191 (``small_q``) and at q = 4294967311
(``big_q``, the same size).  The JAX package folds and proves both big-q
levels, but its ``folded_residual`` takes no signed big-q digit witness,
so the big-q record has no residual (null) and the port's is held to 0."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "two_level.json"

CFG = {"n": 2, "r": 2, "kappa": 16, "seed": 31337, "crs_seed": 0xEC,
       "levels": [{"mu": 0, "crs_seed": 0x5EC0, "key": 99},
                  {"mu": 6, "crs_seed": 0x5EC2, "key": 7}]}


def _params_record(p) -> dict:
    return {"n": p.n, "r": p.r, "k_count": p.k_count, "kappa": p.kappa,
            "beta_override": p.beta_override, "q": p.q}


def _proof_record(sha: str, fs_size: int, report: dict) -> dict:
    return {"transcript_sha256": sha, "transcript_size_in_bytes_fs": fs_size,
            "verify_report": {k: bool(v) for k, v in report.items()}}


def jax_two_level(cfg: dict, big_q: bool = False) -> dict:
    """The golden record from the JAX package's two-level flow."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from labrador_tpu import prover, recursion, sampling, structs, verifier
    from labrador_tpu.crs import CRS
    from labrador_tpu.params import LabradorParams
    from test_torch_e2e import jax_transcript_sha256

    extra = {"q_start": (1 << 32) - 1} if big_q else {}
    p = LabradorParams(n=cfg["n"], r=cfg["r"], kappa_override=cfg["kappa"],
                       exact_digits=True, **extra)
    kw, ks, kv = jax.random.split(jax.random.key(cfg["seed"]), 3)
    witness = sampling.generate_witness(kw, p)
    state = structs.generate_state(ks, witness, p)
    crs = CRS.create(p, seed=cfg["crs_seed"])

    def proved(p, w, st, crs, key):
        proof = jax.device_get(prover.prove(p, w, st, crs, key,
                                            decomp_mode="exact"))
        report = verifier.verify_report(p, st, proof, crs,
                                        decomp_mode="exact")
        with pytest.MonkeyPatch.context() as mp:
            sha = jax_transcript_sha256(proof, p.q, mp)
        return proof, _proof_record(
            sha, structs.transcript_size_in_bytes(proof, p.q, fs=True),
            report)

    proof, base = proved(p, witness, state, crs, kv)
    out = {"config": cfg, "base": {**_params_record(p), **base},
           "levels": []}
    for lv in cfg["levels"]:
        p2, w2, st2, _ = recursion.fold(p, state, proof, crs, mu=lv["mu"])
        residual = None if big_q else \
            int(recursion.folded_residual(st2, w2, p2))
        crs2 = CRS.create(p2, seed=lv["crs_seed"])
        proof2, rec = proved(p2, w2, st2, crs2, jax.random.key(lv["key"]))
        out["levels"].append({**_params_record(p2),
                              "folded_residual": residual, **rec})
        p, state, proof, crs = p2, st2, proof2, crs2
    return out


def port_two_level(cfg: dict, big_q: bool = False, device="cpu") -> dict:
    """The same flow in the port, as the same record."""
    from labrador_tpu_torch import (keys, prover, recursion, sampling,
                                    structs, verifier)
    from labrador_tpu_torch.cli import make_params
    from labrador_tpu_torch.crs import CRS

    p = make_params(cfg["n"], cfg["r"], cfg["kappa"], recursion=True,
                    big_q=big_q)
    kw, ks, kv = keys.split(keys.key(cfg["seed"]), 3)
    witness = sampling.generate_witness(kw, p, device)
    state = structs.generate_state(ks, witness, p)
    crs = CRS.create(p, seed=cfg["crs_seed"])

    def proved(p, w, st, crs, key):
        proof = prover.prove(p, w, st, crs, key, decomp_mode="exact")
        report = verifier.verify_report(p, st, proof, crs,
                                        decomp_mode="exact")
        return proof, _proof_record(
            structs.transcript_sha256(proof, p.q),
            structs.transcript_size_in_bytes(proof, p.q, fs=True), report)

    proof, base = proved(p, witness, state, crs, kv)
    out = {"config": cfg, "base": {**_params_record(p), **base},
           "levels": []}
    for lv in cfg["levels"]:
        p2, w2, st2, _ = recursion.fold(p, state, proof, crs, mu=lv["mu"])
        residual = recursion.folded_residual(st2, w2, p2)
        crs2 = CRS.create(p2, seed=lv["crs_seed"])
        proof2, rec = proved(p2, w2, st2, crs2, keys.key(lv["key"]))
        out["levels"].append({**_params_record(p2),
                              "folded_residual": residual, **rec})
        p, state, proof, crs = p2, st2, proof2, crs2
    return out


@pytest.mark.parametrize("mode", ["small_q", "big_q"])
def test_port_two_level_matches_golden(mode):
    """The port's two levels, field by field against the JAX package's
    record; at big q the record has no residual and the port's is 0."""
    golden = json.loads(GOLDEN.read_text())[mode]
    assert golden["config"] == CFG
    got = port_two_level(CFG, big_q=mode == "big_q")
    assert got["base"] == golden["base"]
    for level, (g, w) in enumerate(zip(got["levels"], golden["levels"]), 1):
        if w["folded_residual"] is None:
            assert g["folded_residual"] == 0, level
            g = {**g, "folded_residual": None}
        for field in w:
            assert g[field] == w[field], (level, field)
        assert g == w, level
    assert len(got["levels"]) == len(golden["levels"]) == 2


@pytest.mark.slow
def test_golden_file_matches_jax():
    """Regenerates the record from the JAX package in a fresh interpreter
    and compares it with the committed file."""
    import os
    import subprocess
    res = subprocess.run([sys.executable, __file__], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT), str(ROOT / "tests")])},
                         capture_output=True, text=True, timeout=7200)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == \
        json.loads(GOLDEN.read_text())


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    record = {"small_q": jax_two_level(CFG),
              "big_q": jax_two_level(CFG, big_q=True)}
    if "--write" in sys.argv:
        GOLDEN.write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    print(json.dumps(record, sort_keys=True))

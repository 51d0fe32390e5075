"""Keeps ``labrador_tpu_torch/golden/config1_recursion.json`` equal to what
the JAX package's ``-R`` flow gives at config 1 (``labrador_tpu/cli.py``:
exact digits, fold, the folded instance's own CRS and key, prove, verify).
The folded proof's interactive size (zlib-9 of its bincode, 10.5 MB after
compression) is left out: its transcript SHA-256 fixes those bytes already, and
tests/test_torch_recursion.py holds both size metrics at a smaller fold.
``tests/test_torch_cuda.py`` holds the port's ``-R`` run on the card
against this file, where there is no JAX; tests/test_torch_recursion.py
holds the port against the JAX package on the CPU, field by field."""

import json
from pathlib import Path

import jax

from labrador_tpu import prover, recursion, sampling, structs, verifier
from labrador_tpu.crs import CRS
from labrador_tpu.params import LabradorParams

from labrador_tpu_torch import cli as tcli
from test_torch_e2e import jax_transcript_sha256

GOLDEN = Path(__file__).resolve().parent.parent / "labrador_tpu_torch" \
    / "golden" / "config1_recursion.json"


def _summary(proof, report, q, monkeypatch, interactive_size=True) -> dict:
    out = {
        "transcript_sha256": jax_transcript_sha256(proof, q, monkeypatch),
        "transcript_size_in_bytes_fs": structs.transcript_size_in_bytes(
            proof, q, fs=True),
        "verify_report": {k: bool(v) for k, v in report.items()},
    }
    if interactive_size:
        out["transcript_size_in_bytes"] = structs.transcript_size_in_bytes(
            proof, q)
    return out


def jax_recursion_golden(cfg: dict, monkeypatch) -> dict:
    """The golden record, regenerated from the JAX package's -R flow."""
    p = LabradorParams(n=cfg["n"], r=cfg["r"], kappa_override=cfg["kappa"],
                       exact_digits=True)
    kw, ks, kv = jax.random.split(jax.random.key(cfg["seed"]), 3)
    witness = sampling.generate_witness(kw, p)
    crs = CRS.create(p, seed=cfg["crs_seed"])
    state = structs.generate_state(ks, witness, p)
    proof = jax.device_get(prover.prove(p, witness, state, crs, kv,
                                        decomp_mode="exact"))
    report = verifier.verify_report(p, state, proof, crs, decomp_mode="exact")
    p2, w2, s2, _ = recursion.fold(p, state, proof, crs)
    crs2 = CRS.create(p2, seed=cfg["folded_crs_seed"])
    proof2 = jax.device_get(prover.prove(
        p2, w2, s2, crs2, jax.random.fold_in(kv, 1), decomp_mode="exact"))
    report2 = verifier.verify_report(p2, s2, proof2, crs2,
                                     decomp_mode="exact")
    return {
        "config": cfg,
        "base": _summary(proof, report, p.q, monkeypatch),
        "folded": {
            "n": p2.n, "r": p2.r, "k_count": p2.k_count,
            "kappa": p2.kappa, "beta_override": p2.beta_override,
            **_summary(proof2, report2, p2.q, monkeypatch,
                       interactive_size=False),
        },
    }


def test_golden_file_matches_jax(monkeypatch):
    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    assert cfg["crs_seed"] == cfg["seed"] * tcli.CRS_SEED_MULT % 2**64
    assert cfg["folded_crs_seed"] == cfg["seed"] ^ tcli.FOLDED_CRS_XOR
    assert golden == jax_recursion_golden(cfg, monkeypatch)

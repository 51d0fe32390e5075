"""The port's config-1 proofs on the reference-parity CRS against
``labrador_tpu_torch/golden/config1_chacha.json``.

The file records what the JAX package gives at config 1 (n = r = 2, q =
8191, the reference's ``main.rs`` demo) on
``MaterializedCRS.create_chacha(P, bytes(range(32)))``, with the witness,
state and verifier key from ``jax.random.key(20240807)`` split in three
(the fixture of ``tests/test_refsim_parity.py``): the SHA-256 of the CRS
table (int32 little endian); for ``prove`` the SHA-256 of the transcript's
bincode stream, ``transcript_size_in_bytes`` and its ``fs=True`` size, and
``verify_report(norm_mode="f64_reference")``; for ``prove_fs`` its digest,
``fs=True`` size, that report and ``fs_challenge_report``.

The Tier-1 test proves both on the CPU in the port and compares;
``chip_smoke.py`` does the same on the card.  The ``slow`` test
regenerates the record from the JAX package in a subprocess (minutes
here); write the file with

    python tests/test_torch_chacha_golden.py --write
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "config1_chacha.json"
CFG = {"n": 2, "r": 2, "base_seed": bytes(range(32)).hex(),
       "key_seed": 20240807}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Few intra-op threads: the port's CPU flows are many small torch
    ops, which stall on the other test processes' threads otherwise."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def table_sha256(coeffs) -> str:
    return hashlib.sha256(np.ascontiguousarray(coeffs, "<i4")
                          .tobytes()).hexdigest()


def _record(sha: str, sizes: dict, report: dict, fs_report=None) -> dict:
    out = {"transcript_sha256": sha, **sizes,
           "verify_report": {k: bool(v) for k, v in report.items()}}
    if fs_report is not None:
        out["fs_challenge_report"] = {k: bool(v)
                                      for k, v in fs_report.items()}
    return out


def jax_chacha_golden(cfg: dict) -> dict:
    """The golden record from the JAX package."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from labrador_tpu import prover, sampling, structs, verifier
    from labrador_tpu.crs import MaterializedCRS
    from labrador_tpu.params import LabradorParams
    from test_torch_e2e import jax_transcript_sha256

    def digest(proof, q):
        with pytest.MonkeyPatch.context() as mp:
            return jax_transcript_sha256(proof, q, mp)

    p = LabradorParams(n=cfg["n"], r=cfg["r"])
    crs = MaterializedCRS.create_chacha(p, bytes.fromhex(cfg["base_seed"]))
    kw, ks, kv = jax.random.split(jax.random.key(cfg["key_seed"]), 3)
    witness = sampling.generate_witness(kw, p)
    state = structs.generate_state(ks, witness, p)
    proof = jax.device_get(prover.prove(p, witness, state, crs, kv))
    proof_fs = jax.device_get(prover.prove_fs(p, witness, state, crs))
    f64 = dict(norm_mode="f64_reference")
    return {
        "config": cfg, "table_sha256": table_sha256(crs.coeffs),
        "prove": _record(
            digest(proof, p.q),
            {"transcript_size_in_bytes":
             structs.transcript_size_in_bytes(proof, p.q),
             "transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof, p.q, fs=True)},
            verifier.verify_report(p, state, proof, crs, **f64)),
        "prove_fs": _record(
            digest(proof_fs, p.q),
            {"transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof_fs, p.q, fs=True)},
            verifier.verify_report(p, state, proof_fs, crs, **f64),
            verifier.fs_challenge_report(p, state, proof_fs, crs))}


def port_chacha_record(device="cpu") -> dict:
    """The same record from the port (what ``chip_smoke.py`` also
    computes on the card)."""
    from labrador_tpu_torch import keys, prover, sampling, structs, verifier
    from labrador_tpu_torch.crs import MaterializedCRS
    from labrador_tpu_torch.params import LabradorParams

    p = LabradorParams(n=CFG["n"], r=CFG["r"])
    crs = MaterializedCRS.create_chacha(p, bytes.fromhex(CFG["base_seed"]),
                                        device=device)
    kw, ks, kv = keys.split(keys.key(CFG["key_seed"]), 3)
    witness = sampling.generate_witness(kw, p, device)
    state = structs.generate_state(ks, witness, p)
    proof = prover.prove(p, witness, state, crs, kv)
    proof_fs = prover.prove_fs(p, witness, state, crs)
    f64 = dict(norm_mode="f64_reference")
    return {
        "config": CFG, "table_sha256": table_sha256(crs.coeffs.cpu()),
        "prove": _record(
            structs.transcript_sha256(proof, p.q),
            {"transcript_size_in_bytes":
             structs.transcript_size_in_bytes(proof, p.q),
             "transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof, p.q, fs=True)},
            verifier.verify_report(p, state, proof, crs, **f64)),
        "prove_fs": _record(
            structs.transcript_sha256(proof_fs, p.q),
            {"transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof_fs, p.q, fs=True)},
            verifier.verify_report(p, state, proof_fs, crs, **f64),
            verifier.fs_challenge_report(p, state, proof_fs, crs))}


def test_port_chacha_proofs_match_golden():
    """``prove`` and ``prove_fs`` on the ChaCha CRS, in the port on the
    CPU, equal the JAX package's record field by field; every check is
    true there."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["config"] == CFG
    assert all(golden["prove"]["verify_report"].values())
    assert all(golden["prove_fs"]["fs_challenge_report"].values())
    got = port_chacha_record()
    for part in ("table_sha256", "prove", "prove_fs"):
        assert got[part] == golden[part], part


@pytest.mark.slow
def test_golden_file_matches_jax():
    """Regenerates the record from the JAX package in a fresh interpreter
    and compares it with the committed file."""
    import os
    import subprocess
    res = subprocess.run([sys.executable, __file__], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT), str(ROOT / "tests")])},
                         capture_output=True, text=True, timeout=3600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == \
        json.loads(GOLDEN.read_text())


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    record = jax_chacha_golden(CFG)
    if "--write" in sys.argv:
        GOLDEN.write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    print(json.dumps(record, sort_keys=True))

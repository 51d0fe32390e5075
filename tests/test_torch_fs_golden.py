"""The port's Fiat-Shamir CLI flows at config 1 against
``labrador_tpu_torch/golden/config1_fs.json``.

The file records what the JAX CLI's flows give at config 1 (n = r = 2,
seed 42, the CLI's CRS seed): ``--fs`` at q = 8191 (``small_q``) and at q
= 4294967311 (``big_q``), and ``--fs -R`` at q = 8191 (``recursion``: the
FS base proof folded, the folded instance proved interactively with
fold_in(kv, 1) and its own CRS).  For each proof: the SHA-256 of its
bincode stream, ``transcript_size_in_bytes(fs=True)``, the verify report
and, for an FS proof, ``fs_challenge_report``; for the folded one its
shape too.  The folded proof's interactive size (10 MB of zlib-9) is left
out: its digest fixes those bytes.

The Tier-1 tests run the port's CLI flows on the CPU against the file;
``chip_smoke.py`` runs them on the card.  The ``slow`` test regenerates
the record from the JAX package in a subprocess (a few minutes here);
write the file with

    python tests/test_torch_fs_golden.py --write
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden" / "config1_fs.json"

CFG = {"n": 2, "r": 2, "kappa": 0, "seed": 42,
       "crs_seed": 42 * 0x9E3779B97F4A7C15 % 2**64,
       "folded_crs_seed": 42 ^ 0xF01D}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU flows here are thousands of small torch ops: two
    intra-op threads keep them from stalling on the other test processes'
    threads when the suite runs in parallel (8 threads took 10-20x longer
    there than alone)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _record(sha: str, fs_size: int, report: dict, fs_report=None) -> dict:
    out = {"transcript_sha256": sha, "transcript_size_in_bytes_fs": fs_size,
           "verify_report": {k: bool(v) for k, v in report.items()}}
    if fs_report is not None:
        out["fs_challenge_report"] = {k: bool(v)
                                      for k, v in fs_report.items()}
    return out


def _folded_shape(p) -> dict:
    return {"n": p.n, "r": p.r, "k_count": p.k_count, "kappa": p.kappa,
            "beta_override": p.beta_override}


def jax_fs_golden(cfg: dict) -> dict:
    """The golden record from the JAX CLI's --fs flows."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from labrador_tpu import prover, recursion, sampling, structs, verifier
    from labrador_tpu.crs import CRS
    from labrador_tpu.params import LabradorParams
    from test_torch_e2e import jax_transcript_sha256

    def digest(proof, q):
        with pytest.MonkeyPatch.context() as mp:
            return jax_transcript_sha256(proof, q, mp)

    def fs_flow(big_q: bool, recursive: bool):
        extra = {"q_start": (1 << 32) - 1} if big_q else {}
        exact = big_q or recursive
        mode = "exact" if exact else "reference"
        p = LabradorParams(n=cfg["n"], r=cfg["r"],
                           kappa_override=cfg["kappa"], exact_digits=exact,
                           **extra)
        kw, ks, kv = jax.random.split(jax.random.key(cfg["seed"]), 3)
        witness = sampling.generate_witness(kw, p)
        crs = CRS.create(p, seed=cfg["crs_seed"])
        state = structs.generate_state(ks, witness, p)
        proof = jax.device_get(prover.prove_fs(p, witness, state, crs,
                                               decomp_mode=mode))
        rec = _record(digest(proof, p.q),
                      structs.transcript_size_in_bytes(proof, p.q, fs=True),
                      verifier.verify_report(p, state, proof, crs,
                                             decomp_mode=mode),
                      verifier.fs_challenge_report(p, state, proof, crs))
        if not recursive:
            return rec
        p2, w2, s2, _ = recursion.fold(p, state, proof, crs)
        crs2 = CRS.create(p2, seed=cfg["folded_crs_seed"])
        proof2 = jax.device_get(prover.prove(
            p2, w2, s2, crs2, jax.random.fold_in(kv, 1), decomp_mode="exact"))
        folded = _record(
            digest(proof2, p2.q),
            structs.transcript_size_in_bytes(proof2, p2.q, fs=True),
            verifier.verify_report(p2, s2, proof2, crs2,
                                   decomp_mode="exact"))
        return {"base": rec, "folded": {**_folded_shape(p2), **folded}}

    return {"config": cfg, "small_q": fs_flow(False, False),
            "big_q": fs_flow(True, False),
            "recursion": fs_flow(False, True)}


def port_fs_flow(big_q: bool, recursive: bool, device="cpu") -> dict:
    """The port's CLI flow (``run_flow(fs=True)``) as the same record."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    res = run_flow(CFG["n"], CFG["r"], CFG["kappa"], CFG["seed"], device,
                   recursion=recursive, big_q=big_q, fs=True)
    p, proof = res.params, res.proof
    fs_keys = [k for k in res.report if k.startswith("fs_")]
    rec = _record(structs.transcript_sha256(proof, p.q),
                  structs.transcript_size_in_bytes(proof, p.q, fs=True),
                  {k: v for k, v in res.report.items() if k not in fs_keys},
                  {k: res.report[k] for k in fs_keys})
    if not recursive:
        return rec
    f = res.folded
    folded = _record(structs.transcript_sha256(f.proof, f.params.q),
                     structs.transcript_size_in_bytes(f.proof, f.params.q,
                                                      fs=True), f.report)
    assert f.residual == 0
    return {"base": rec, "folded": {**_folded_shape(f.params), **folded}}


@pytest.mark.parametrize("mode", ["small_q", "big_q", "recursion"])
def test_port_fs_flow_matches_golden(mode):
    """``cli --fs`` (small and big q) and ``cli --fs -R`` in the port, on
    the CPU, equal the JAX package's record field by field; every check
    and FS check is true there."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["config"] == CFG
    want = golden[mode]
    got = port_fs_flow(big_q=mode == "big_q", recursive=mode == "recursion")
    base = want["base"] if mode == "recursion" else want
    assert all(base["fs_challenge_report"].values())
    assert all(base["verify_report"].values())
    for field in want:
        assert got[field] == want[field], field


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
    record = jax_fs_golden(CFG)
    if "--write" in sys.argv:
        GOLDEN.write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    print(json.dumps(record, sort_keys=True))

"""The port's side of two config-1 golden records, importing nothing of
JAX: ``labrador_tpu_torch/golden/config1_fs.json`` (the CLI's ``--fs``
flows) and ``config1_chacha.json`` (``prove`` and ``prove_fs`` on the
reference-parity CRS).  ``tests/test_torch_fs_golden.py`` and
``tests/test_torch_chacha_golden.py`` hold the records' JAX side and
compare on the CPU; ``tests/test_torch_cuda.py`` compares on the card.
"""

from __future__ import annotations

import hashlib

import numpy as np

FS_CFG = {"n": 2, "r": 2, "kappa": 0, "seed": 42,
          "crs_seed": 42 * 0x9E3779B97F4A7C15 % 2**64,
          "folded_crs_seed": 42 ^ 0xF01D}
CHACHA_CFG = {"n": 2, "r": 2, "base_seed": bytes(range(32)).hex(),
              "key_seed": 20240807}


def record(sha: str, sizes: dict, report: dict, fs_report=None) -> dict:
    """One proof's record: its digest, the sizes given, its verify report
    and, for an FS proof, its fs_challenge_report."""
    out = {"transcript_sha256": sha, **sizes,
           "verify_report": {k: bool(v) for k, v in report.items()}}
    if fs_report is not None:
        out["fs_challenge_report"] = {k: bool(v)
                                      for k, v in fs_report.items()}
    return out


def folded_shape(p) -> dict:
    return {"n": p.n, "r": p.r, "k_count": p.k_count, "kappa": p.kappa,
            "beta_override": p.beta_override}


def table_sha256(coeffs) -> str:
    """SHA-256 of a CRS table as int32 little endian."""
    return hashlib.sha256(np.ascontiguousarray(coeffs, "<i4")
                          .tobytes()).hexdigest()


def port_fs_flow(big_q: bool, recursive: bool, device="cpu") -> dict:
    """The port's CLI flow (``run_flow(fs=True)``) as config1_fs.json's
    record of its mode."""
    from labrador_tpu_torch import structs
    from labrador_tpu_torch.cli import run_flow

    res = run_flow(FS_CFG["n"], FS_CFG["r"], FS_CFG["kappa"], FS_CFG["seed"],
                   device, recursion=recursive, big_q=big_q, fs=True)
    p, proof = res.params, res.proof
    fs_keys = [k for k in res.report if k.startswith("fs_")]
    rec = record(structs.transcript_sha256(proof, p.q),
                 {"transcript_size_in_bytes_fs":
                  structs.transcript_size_in_bytes(proof, p.q, fs=True)},
                 {k: v for k, v in res.report.items() if k not in fs_keys},
                 {k: res.report[k] for k in fs_keys})
    if not recursive:
        return rec
    f = res.folded
    folded = record(structs.transcript_sha256(f.proof, f.params.q),
                    {"transcript_size_in_bytes_fs":
                     structs.transcript_size_in_bytes(f.proof, f.params.q,
                                                      fs=True)}, f.report)
    assert f.residual == 0
    return {"base": rec, "folded": {**folded_shape(f.params), **folded}}


def chacha_proofs(device="cpu"):
    """Config 1 on the ChaCha CRS of CHACHA_CFG: (params, CRS, witness,
    state, prove's proof, prove_fs's proof)."""
    from labrador_tpu_torch import keys, prover, sampling, structs
    from labrador_tpu_torch.crs import MaterializedCRS
    from labrador_tpu_torch.params import LabradorParams

    p = LabradorParams(n=CHACHA_CFG["n"], r=CHACHA_CFG["r"])
    crs = MaterializedCRS.create_chacha(
        p, bytes.fromhex(CHACHA_CFG["base_seed"]), device=device)
    kw, ks, kv = keys.split(keys.key(CHACHA_CFG["key_seed"]), 3)
    witness = sampling.generate_witness(kw, p, device)
    state = structs.generate_state(ks, witness, p)
    return (p, crs, witness, state, prover.prove(p, witness, state, crs, kv),
            prover.prove_fs(p, witness, state, crs))


def chacha_record(p, crs, witness, state, proof, proof_fs) -> dict:
    """config1_chacha.json's record of ``chacha_proofs``'s result."""
    from labrador_tpu_torch import structs, verifier

    f64 = dict(norm_mode="f64_reference")
    return {
        "config": CHACHA_CFG, "table_sha256": table_sha256(crs.coeffs.cpu()),
        "prove": record(
            structs.transcript_sha256(proof, p.q),
            {"transcript_size_in_bytes":
             structs.transcript_size_in_bytes(proof, p.q),
             "transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof, p.q, fs=True)},
            verifier.verify_report(p, state, proof, crs, **f64)),
        "prove_fs": record(
            structs.transcript_sha256(proof_fs, p.q),
            {"transcript_size_in_bytes_fs":
             structs.transcript_size_in_bytes(proof_fs, p.q, fs=True)},
            verifier.verify_report(p, state, proof_fs, crs, **f64),
            verifier.fs_challenge_report(p, state, proof_fs, crs))}


def port_chacha_record(device="cpu") -> dict:
    return chacha_record(*chacha_proofs(device))

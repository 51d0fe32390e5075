"""End to end on the CPU: the JAX package and the PyTorch port prove and
verify the same config-1 instance (carried across with ``interop``), and
must agree exactly — every transcript field, both proof-size metrics, the
verify_report dict, the tamper rejections of tests/test_e2e.py.  Also
keeps ``labrador_tpu_torch/golden/config1.json`` (what
tests/test_torch_cuda.py checks on the card, where there is no JAX) equal
to what the JAX package gives."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_tpu import protocol as jprotocol
from labrador_tpu import prover as jprover
from labrador_tpu import sampling as jsampling
from labrador_tpu import structs as jstructs
from labrador_tpu import verifier as jverifier
from labrador_tpu.crs import CRS as JCRS
from labrador_tpu.ops.modmath import mod_pos as jmod_pos
from labrador_tpu.params import LabradorParams

from labrador_tpu_torch import cli as tcli
from labrador_tpu_torch import interop
from labrador_tpu_torch import protocol as tprotocol
from labrador_tpu_torch import prover as tprover
from labrador_tpu_torch import structs as tstructs
from labrador_tpu_torch import verifier as tverifier
from labrador_tpu_torch.crs import CRS as TCRS

GOLDEN = Path(__file__).resolve().parent.parent / "labrador_tpu_torch" \
    / "golden" / "config1.json"
CFG = json.loads(GOLDEN.read_text())["config"]
P = LabradorParams(n=CFG["n"], r=CFG["r"], kappa_override=CFG["kappa"])


class _Sha256Tap:
    """Stands in for ``zlib`` inside the JAX structs module: hashes the
    exact byte stream that transcript_size_in_bytes would compress."""

    def __init__(self):
        import hashlib
        self.h = hashlib.sha256()

    def compressobj(self, level):
        return self

    def compress(self, blk):
        self.h.update(blk)
        return b""

    def flush(self):
        return b""


def jax_transcript_sha256(proof, q, monkeypatch) -> str:
    tap = _Sha256Tap()
    with monkeypatch.context() as m:
        m.setattr(jstructs, "zlib", tap)
        jstructs.transcript_size_in_bytes(proof, q)
    return tap.h.hexdigest()


def _fields(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX CLI flow at config 1 (labrador_tpu/cli.py)."""
    kw, ks, kv = jax.random.split(jax.random.key(CFG["seed"]), 3)
    witness = jsampling.generate_witness(kw, P)
    crs = JCRS.create(P, seed=CFG["crs_seed"])
    state = jstructs.generate_state(ks, witness, P)
    proof = jax.device_get(jprover.prove(P, witness, state, crs, kv))
    report = {k: bool(v) for k, v in
              jverifier.verify_report(P, state, proof, crs).items()}
    return dict(witness=witness, state=state, crs=crs, kv=kv, proof=proof,
                report=report)


@pytest.fixture(scope="module")
def torch_run(jax_run):
    """The port proves and verifies the JAX instance, carried across."""
    st_names = ("a_k", "phi_k", "b_k", "a_prime_k", "phi_prime_k",
                "b_prime_k")
    state = interop.state_from_numpy(_fields(jax_run["state"], st_names),
                                     device="cpu")
    witness = interop.tensor(np.asarray(jax_run["witness"]), device="cpu")
    crs = interop.crs_from_words(np.asarray(jax_run["crs"].key), P)
    kv = interop.key_from_words(jax.random.key_data(jax_run["kv"]))
    proof = tprover.prove(P, witness, state, crs, kv)
    report = tverifier.verify_report(P, state, proof, crs)
    return dict(state=state, crs=crs, proof=proof, report=report)


TR_FIELDS = jstructs.TRANSCRIPT_FIELDS + ("pi", "jl_ok", "b_pp_ok")


@pytest.mark.parametrize("field", TR_FIELDS)
def test_transcript_field_equal(jax_run, torch_run, field):
    want = np.asarray(getattr(jax_run["proof"], field))
    got = getattr(torch_run["proof"], field).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("fs", [False, True], ids=["interactive", "fs"])
def test_size_in_bytes_equal(jax_run, torch_run, fs):
    assert tstructs.transcript_size_in_bytes(torch_run["proof"], P.q, fs) \
        == jstructs.transcript_size_in_bytes(jax_run["proof"], P.q, fs)


def test_bincode_bytes_equal(jax_run, torch_run, monkeypatch):
    assert tstructs.transcript_sha256(torch_run["proof"], P.q) == \
        jax_transcript_sha256(jax_run["proof"], P.q, monkeypatch)


def test_verify_report_equal(jax_run, torch_run):
    assert torch_run["report"] == jax_run["report"]
    assert all(torch_run["report"].values())


def test_port_verifies_jax_proof(jax_run, torch_run):
    """The JAX package's proof, carried across field by field, gets the
    same report from the port's verifier."""
    proof = interop.transcript_from_numpy(_fields(jax_run["proof"],
                                                  TR_FIELDS), device="cpu")
    got = tverifier.verify_report(P, torch_run["state"], proof,
                                  torch_run["crs"])
    assert got == jax_run["report"]


def jax_golden(jax_run, monkeypatch) -> dict:
    """The golden record, regenerated from the JAX package."""
    proof = jax_run["proof"]
    return {
        "config": CFG,
        "transcript_sha256": jax_transcript_sha256(proof, P.q, monkeypatch),
        "transcript_size_in_bytes": jstructs.transcript_size_in_bytes(
            proof, P.q),
        "transcript_size_in_bytes_fs": jstructs.transcript_size_in_bytes(
            proof, P.q, fs=True),
        "verify_report": jax_run["report"],
    }


def test_golden_file_matches_jax(jax_run, monkeypatch):
    assert CFG["crs_seed"] == CFG["seed"] * tcli.CRS_SEED_MULT % 2**64
    assert json.loads(GOLDEN.read_text()) == jax_golden(jax_run, monkeypatch)


def test_port_cli_flow_matches_golden():
    """The port's own flow from the seed (its key streams for witness,
    state and challenges) reproduces the JAX transcript."""
    g = json.loads(GOLDEN.read_text())
    res = tcli.run_flow(CFG["n"], CFG["r"], CFG["kappa"], CFG["seed"], "cpu")
    assert tstructs.transcript_sha256(res.proof, P.q) == g["transcript_sha256"]
    assert tstructs.transcript_size_in_bytes(res.proof, P.q) == \
        g["transcript_size_in_bytes"]
    assert res.report == g["verify_report"]


def test_save_transcript_members_equal(jax_run, torch_run, tmp_path):
    """Same .npy members (names, dtypes, bytes); only the zip entries'
    timestamps may differ."""
    jstructs.save_transcript(jax_run["proof"], str(tmp_path / "j.npz"))
    tstructs.save_transcript(torch_run["proof"], str(tmp_path / "t.npz"), P.q)
    import zipfile
    with zipfile.ZipFile(tmp_path / "j.npz") as zj, \
            zipfile.ZipFile(tmp_path / "t.npz") as zt:
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zt.read(name), name


# -- tamper rejection (tests/test_e2e.py), on both packages ----------------

def _tamper(kind, proof, torch_side):
    """(changes to the transcript, CRS seed) for one tamper case."""
    if kind == "z":
        if torch_side:
            z = proof.z.clone()
            z[0, 3] = (z[0, 3] + 1) % P.q
            return {"z": z}
        return {"z": jmod_pos(jnp.asarray(proof.z).at[0, 3].add(1), P.q)}
    if kind == "g":
        if torch_side:
            g = proof.g.clone()
            g[0, 1, 0] = (g[0, 1, 0] + 1) % P.q
            return {"g": g}
        return {"g": jmod_pos(jnp.asarray(proof.g).at[0, 1, 0].add(1), P.q)}
    if kind == "u1":
        if torch_side:
            u = proof.u_1.clone()
            u[5, 7] = (u[5, 7] + 1) % P.q
            return {"u_1": u}
        return {"u_1": jmod_pos(jnp.asarray(proof.u_1).at[5, 7].add(1), P.q)}
    if kind == "oversized_t":
        if torch_side:
            return {"t": torch.full_like(proof.t, P.q - 1)}
        return {"t": jnp.full_like(jnp.asarray(proof.t), P.q - 1)}
    return {}


EXPECT_FALSE = {"z": ("c15_az_vs_ct", "all"), "g": ("c08_g_symmetric",),
                "u1": ("c19_u1", "all"), "wrong_crs": ("all",),
                "oversized_t": ("all",)}


@pytest.mark.parametrize("kind", list(EXPECT_FALSE))
def test_tampered_transcript_rejected(jax_run, torch_run, kind):
    jproof, tproof = jax_run["proof"], torch_run["proof"]
    jcrs, tcrs = jax_run["crs"], torch_run["crs"]
    if kind == "wrong_crs":
        jcrs, tcrs = JCRS.create(P, 0xBAD5EED), TCRS.create(P, 0xBAD5EED)
    jbad = jproof.replace(**_tamper(kind, jproof, False))
    tbad = tproof.replace(**_tamper(kind, tproof, True))
    want = {k: bool(v) for k, v in
            jverifier.verify_report(P, jax_run["state"], jbad, jcrs).items()}
    got = tverifier.verify_report(P, torch_run["state"], tbad, tcrs)
    assert got == want
    for check in EXPECT_FALSE[kind]:
        assert not got[check], check


@pytest.mark.parametrize("norm_mode", ["exact", "f64_reference"])
@pytest.mark.parametrize("decomp_mode", ["reference", "exact"])
@pytest.mark.parametrize("oversized_z", [False, True],
                         ids=["proof_z", "oversized_z"])
def test_check14_digits_and_norm_equal(jax_run, decomp_mode, norm_mode,
                                       oversized_z):
    """Check 14 and the digits it reads, on the config-1 proof, in both
    digit modes (exact digits with exact_digits params, which adds the
    ||z||^2 conjunct) and both norm modes; an oversized z must fail the
    exact-mode z bound on both sides."""
    p = P if decomp_mode == "reference" else LabradorParams(
        n=CFG["n"], r=CFG["r"], kappa_override=CFG["kappa"],
        exact_digits=True)
    proof = jax_run["proof"]
    arrays = {n: np.asarray(getattr(proof, n)) for n in ("z", "t", "g", "h")}
    if oversized_z:
        arrays["z"] = np.full_like(arrays["z"], P.q // 2)
    jdig, tdig = [], []
    for name, x in arrays.items():
        fn = f"decompose_{name}"
        jd = getattr(jprotocol, fn)(jnp.asarray(x, jnp.int32), p, decomp_mode)
        td = getattr(tprotocol, fn)(interop.tensor(x, device="cpu"), p,
                                    decomp_mode)
        np.testing.assert_array_equal(td.numpy(),
                                      np.asarray(jd).astype(np.int64))
        jdig.append(jd)
        tdig.append(td)
    want = bool(jverifier.check14_norm_bound(
        p, jnp.asarray(arrays["z"], jnp.int32), *jdig, norm_mode))
    got = tverifier.check14_norm_bound(p, interop.tensor(arrays["z"], "cpu"),
                                       *tdig, norm_mode)
    assert got == want
    if oversized_z and decomp_mode == norm_mode == "exact":
        assert not got
    if not oversized_z:
        assert got


@pytest.mark.parametrize("flag", [["--fs"], ["--big-q", "--fs"],
                                  ["-R", "--big-q", "--phases"],
                                  ["--phases"], ["--ckpt", "x"]])
def test_cli_unported_flags_exit(flag, tmp_path, capsys, monkeypatch):
    """The flags the CLI once turned away (Fiat-Shamir, phases,
    checkpoints) run on the CPU: exit 0 and the verdict printed (-R
    meets --big-q at kappa 16; the checkpoint goes to a temporary
    directory).  The size metric is stubbed: the zlib-9 of the folded
    interactive proof takes minutes here, and the sizes are held
    elsewhere (the golden files)."""
    flag = [str(tmp_path / a) if a == "x" else a for a in flag]
    if "-R" in flag and "--big-q" in flag:
        flag += ["--kappa", "16"]
    monkeypatch.setattr(tcli.structs, "transcript_size_in_bytes",
                        lambda *a, **k: 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # small torch ops: see test_torch_fs.py
    try:
        assert tcli.main(["--device", "cpu", "--verbose", *flag]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "Success: Proof Verified!" in out
    if "-R" in flag:
        assert "Success: recursive proof verified!" in out
    if "--phases" in flag or "--ckpt" in flag:
        assert "p3_opening" in out
    if "--ckpt" in flag:
        assert (tmp_path / "x").exists()


def test_cli_cpu_verbose(capsys):
    assert tcli.main(["--device", "cpu", "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "Success: Proof Verified!" in out
    assert "commitment kernels: plain" in out

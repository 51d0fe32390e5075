"""The port's Fiat-Shamir mode against the JAX package on the CPU.

* SHA-256 (``ops/sha256``): both routes, ``hashlib`` on the host and the
  batched compress in torch ops, against hashlib, the FIPS 180-4 vectors
  and the JAX ``sha256_words`` / ``hash_arrays``, at word counts across
  the padding and block boundaries and for int8 / int32 / uint32 leaves.
* The SHA-256 streams (``ops/sha_prng``, ``keys.ShaKey``): ``split``,
  ``fold_in``, ``bits``, ``bernoulli``, ``permutation`` and the samplers
  against ``jax.random`` on ``wrap_digest`` keys; the host and the device
  route equal at every block and chunk boundary.
* One JAX ``prove_fs`` at config 1, q = 8191 (the CLI's seeds), held
  field by field against the port's; each package's
  ``fs_challenge_report`` and ``verify_fs`` on the other's proof and its
  tampered copies; the port's versions of tests/test_fiat_shamir.py.
* The big-q ``fs_jl_norm`` wrap forgery, and ``load_transcript`` of files
  the JAX package wrote.
* The stream kernel (``csrc/sha_stream.cu``): its constants against
  ``ops/sha256``'s, and the CPU route of ``stream_device`` that never
  reaches it.  The kernel itself is held against hashlib on a card by
  ``tests/test_torch_cuda.py``.
"""

import hashlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labrador_tpu import prover as jprover
from labrador_tpu import sampling as jsampling
from labrador_tpu import structs as jstructs
from labrador_tpu import verifier as jverifier
from labrador_tpu.crs import CRS as JCRS
from labrador_tpu.ops import sha256 as jsha
from labrador_tpu.ops import zq as jzq
from labrador_tpu.ops.sha_prng import wrap_digest
from labrador_tpu.params import LabradorParams

from labrador_tpu_torch import keys, prover, sampling, structs, verifier
from labrador_tpu_torch.cli import CRS_SEED_MULT, run_flow
from labrador_tpu_torch.ops import cuda_lib, sha256, sha_cuda, sha_prng
from labrador_tpu_torch.ops.modmath import sum_sq_u64

SEED = 42
P = LabradorParams(n=2, r=2)
DIGEST = hashlib.sha256(b"labrador fs test").digest()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU flows here are thousands of small torch ops: two
    intra-op threads keep them from stalling on the other test processes'
    threads when the suite runs in parallel (8 threads took 10-20x longer
    there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _words(digest: bytes) -> np.ndarray:
    return np.frombuffer(digest, ">u4").astype(np.uint32)


def _random_words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, n,
                                                dtype=np.uint64)


# ---------------------------------------------------------------------------
# SHA-256
# ---------------------------------------------------------------------------

FIPS = [(b"",
         "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
        (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
         "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1")]


@pytest.mark.parametrize("msg,want", FIPS, ids=["empty", "two_block"])
def test_sha256_fips_vectors(msg, want):
    """FIPS 180-4's word-aligned examples on both routes."""
    words = np.frombuffer(msg, ">u4").astype(np.int64)
    assert sha256.sha256_words(words).hex() == want
    got = sha256.sha256_batch([int(w) for w in words])
    assert bytes(np.asarray(got, ">u4").tobytes()).hex() == want


@pytest.mark.parametrize("n_words", [0, 1, 7, 8, 9, 13, 14, 15, 16, 17, 29,
                                     30, 31, 32, 33, 100])
def test_sha256_batch_matches_hashlib(n_words):
    """The batched compress (a batch of 5 messages, one word a constant)
    against hashlib at word counts across the 52 / 56 / 64-byte padding
    boundaries and several blocks."""
    rng = np.random.default_rng(n_words)
    msgs = rng.integers(0, 1 << 32, (5, n_words), dtype=np.uint64)
    if n_words:
        msgs[:, 0] = 0xDEADBEEF
    cols = [torch.from_numpy(msgs[:, i].astype(np.int64))
            for i in range(n_words)]
    if n_words:
        cols[0] = 0xDEADBEEF
    got = sha256.sha256_batch(cols)
    got = torch.stack([torch.as_tensor(g).expand(5) for g in got], 1)
    for row in range(5):
        want = hashlib.sha256(msgs[row].astype(">u4").tobytes()).digest()
        assert bytes(got[row].numpy().astype(">u4").tobytes()) == want
        assert sha256.sha256_words(msgs[row]) == want


@pytest.mark.parametrize("n_words", [0, 13, 14, 16, 17])
def test_sha256_words_matches_jax(n_words):
    words = _random_words(n_words, 100 + n_words)
    want = np.asarray(jsha.sha256_words(jnp.asarray(words.astype(np.uint32))))
    np.testing.assert_array_equal(_words(sha256.sha256_words(words)), want)


def test_hash_arrays_matches_jax():
    """Domain tag, a 32-byte state, and int8 (sign-extended), int32 and
    uint32 leaves; the port takes int64 tensors in those ranges too."""
    rng = np.random.default_rng(5)
    i8 = rng.integers(-128, 128, 37).astype(np.int8)
    i32 = rng.integers(-(1 << 31), 1 << 31, (3, 5)).astype(np.int32)
    u32 = rng.integers(0, 1 << 32, 6, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jsha.hash_arrays(jnp.asarray(_words(DIGEST)),
                                       jnp.asarray(i8), jnp.asarray(i32),
                                       jnp.asarray(u32), domain=7))
    got = sha256.hash_arrays(DIGEST, torch.from_numpy(i8),
                             torch.from_numpy(i32.astype(np.int64)),
                             torch.from_numpy(u32.astype(np.int64)),
                             domain=7)
    np.testing.assert_array_equal(_words(got), want)
    assert sha256.hash_arrays(DIGEST, i8, i32, u32, domain=7) == got
    with pytest.raises(TypeError):
        sha256.hash_arrays(torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        sha256.hash_arrays(torch.tensor([1 << 32]))


def test_hash_arrays_chunks(monkeypatch):
    """A leaf longer than one host chunk hashes as one message."""
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -128, 128, 1000).astype(np.int8))
    whole = sha256.hash_arrays(x, domain=3)
    monkeypatch.setattr(sha256, "HOST_CHUNK", 7)
    assert sha256.hash_arrays(x, domain=3) == whole
    assert whole == hashlib.sha256(
        np.asarray([3] + x.tolist(), ">i4").tobytes()).digest()


# ---------------------------------------------------------------------------
# The SHA-256 streams and ShaKey
# ---------------------------------------------------------------------------

KEYS16 = [hashlib.sha256(bytes([i])).digest() for i in range(16)]
KEYS3 = KEYS16[:3]


@pytest.mark.parametrize("n_words", [1, 7, 8, 9, 15, 16, 17, 64, 1001])
@pytest.mark.parametrize("n_keys", [1, 3])
def test_stream_routes_equal(n_words, n_keys, monkeypatch):
    """stream_device (batched compress) == stream_host (hashlib) at partial
    and whole final blocks, one key (host constants) and several, and
    with chunks of 3 blocks (chunk edges inside and across keys)."""
    ks = KEYS3[:n_keys]
    want = sha_prng.stream_host(ks, n_words).astype(np.int64)
    got = sha_prng.stream_device(ks, n_words, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(sha_prng, "STREAM_CHUNK_BLOCKS", 3)
    np.testing.assert_array_equal(
        sha_prng.stream_device(ks, n_words, "cpu").numpy(), want)


def test_random_bits_route_by_length(monkeypatch):
    """random_bits takes the device route from DEVICE_STREAM_BLOCKS blocks
    on, the host route below; the words are the same."""
    calls = []
    host, dev = sha_prng.stream_host, sha_prng.stream_device
    monkeypatch.setattr(sha_prng, "stream_host",
                        lambda *a: calls.append("host") or host(*a))
    monkeypatch.setattr(sha_prng, "stream_device",
                        lambda *a: calls.append("device") or dev(*a))
    monkeypatch.setattr(sha_prng, "DEVICE_STREAM_BLOCKS", 6)
    short = sha_prng.random_bits(KEYS3[:2], 17, "cpu")      # 2 * 3 blocks
    shorter = sha_prng.random_bits(KEYS3[:1], 17, "cpu")    # 3 blocks
    assert calls == ["device", "host"]
    np.testing.assert_array_equal(short[0].numpy(), shorter[0].numpy())


def test_stream_kernel_constants_match():
    """The round constants and H0 written in csrc/sha_stream.cu equal
    ops/sha256's K and H0: the kernel cannot run here, so its source is
    read."""
    src = (cuda_lib.CSRC / "sha_stream.cu").read_text()

    def table(name: str) -> tuple[int, ...]:
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src)[1]
        return tuple(int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})", body))

    assert table("SHA_K") == sha256.K
    assert table("SHA_H0") == sha256.H0


def test_stream_device_cpu_takes_plain_route(monkeypatch):
    """On a CPU tensor stream_device hashes through sha256_batch, the
    plain route, and never reaches the kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route was taken on the CPU")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    monkeypatch.setattr(sha_cuda, "sha_stream", refuse)
    calls = []
    batch = sha_prng.sha256_batch
    monkeypatch.setattr(sha_prng, "sha256_batch",
                        lambda words: calls.append(1) or batch(words))
    launches = sha_cuda.KERNEL.launches
    got = sha_prng.stream_device(KEYS3, 17, "cpu")
    assert calls and sha_cuda.KERNEL.launches == launches
    np.testing.assert_array_equal(
        got.numpy(), sha_prng.stream_host(KEYS3, 17).astype(np.int64))


def test_sha_key_derivations_match_jax():
    """split, fold_in, bits (one and several keys), bernoulli and
    permutation of a ShaKey against jax.random on wrap_digest."""
    jk = wrap_digest(jnp.asarray(_words(DIGEST)))
    k = keys.ShaKey(DIGEST)
    for i, (a, b) in enumerate(zip(keys.split(k, 3),
                                   jax.random.split(jk, 3))):
        np.testing.assert_array_equal(_words(a.digest),
                                      np.asarray(jax.random.key_data(b)))
    for data in (0, 5, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            _words(keys.fold_in(k, data).digest),
            np.asarray(jax.random.key_data(jax.random.fold_in(jk, data))))
    for shape in ((1,), (9,), (3, 7), (2, 64, 2)):
        np.testing.assert_array_equal(
            keys.bits(k, shape, "cpu").numpy(),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(
                np.int64))
    ks = keys.split(k, 3)
    stacked = keys.bits_stack(ks, (4, 5), "cpu")
    for kk, row in zip(ks, stacked):
        assert torch.equal(row, keys.bits(kk, (4, 5), "cpu"))
    np.testing.assert_array_equal(
        keys.bernoulli(k, 0.5, (64,), "cpu").numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.5, (64,))))
    np.testing.assert_array_equal(
        keys.permutation(k, torch.arange(64)).numpy(),
        np.asarray(jax.random.permutation(jk, jnp.arange(64))))


def test_sha_key_samplers_match_jax():
    """The challenge, psi and JL samplers on ShaKeys (the FS oracle's)."""
    jk = wrap_digest(jnp.asarray(_words(DIGEST)))
    k = keys.ShaKey(DIGEST)
    np.testing.assert_array_equal(
        sampling.sample_challenge(k, P, "cpu").numpy(),
        np.asarray(jsampling.sample_challenge(jk, P)))
    np.testing.assert_array_equal(
        sampling.sample_psi(k, P, "cpu").numpy(),
        np.asarray(jsampling.sample_psi(jk, P)))
    np.testing.assert_array_equal(
        sampling.sample_jl_matrix(k, P, "cpu").numpy(),
        np.asarray(jsampling.sample_jl_matrix(jk, P)))


# ---------------------------------------------------------------------------
# prove_fs / fs_challenge_report / verify_fs against the JAX package
# ---------------------------------------------------------------------------

def _jax_transcript(tr: structs.Transcript):
    """A port transcript at small q as a JAX Transcript (int32 residues)."""
    fields = {}
    for name in tr.__dataclass_fields__:
        a = getattr(tr, name).numpy()
        fields[name] = jnp.asarray(a if a.dtype in (np.int8, np.bool_)
                                   else a.astype(np.int32))
    return jstructs.Transcript(**fields)


@pytest.fixture(scope="module")
def fs_run():
    """The JAX CLI's --fs flow at config 1 and the port's, from the same
    seeds (each package derives its own witness, state and CRS)."""
    kw, ks, _ = jax.random.split(jax.random.key(SEED), 3)
    witness = jsampling.generate_witness(kw, P)
    crs = JCRS.create(P, seed=SEED * CRS_SEED_MULT % 2**64)
    state = jstructs.generate_state(ks, witness, P)
    proof = jax.device_get(jprover.prove_fs(P, witness, state, crs))
    port = run_flow(P.n, P.r, 0, SEED, "cpu", fs=True)
    return dict(state=state, crs=crs, proof=proof, witness=witness,
                port=port)


def test_prove_fs_matches_jax(fs_run, monkeypatch):
    """Every transcript field, the bincode SHA-256 and both sizes."""
    from test_torch_e2e import jax_transcript_sha256
    jp, port = fs_run["proof"], fs_run["port"]
    for name in jp.__dataclass_fields__:
        np.testing.assert_array_equal(
            getattr(port.proof, name).numpy(),
            np.asarray(getattr(jp, name)).astype(
                getattr(port.proof, name).numpy().dtype), err_msg=name)
    assert structs.transcript_sha256(port.proof, P.q) == \
        jax_transcript_sha256(jp, P.q, monkeypatch)
    for fs in (False, True):
        assert structs.transcript_size_in_bytes(port.proof, P.q, fs=fs) == \
            jstructs.transcript_size_in_bytes(jp, P.q, fs=fs)
    assert port.ok and all(port.report.values())


def _tampers(q: int):
    """(name, transcript -> tampered transcript, FS check that must fail)
    on port transcripts: a forged challenge c, a changed u1 (every later
    challenge moves), a changed projection entry, a changed b''."""
    def bump(name, idx):
        def f(tr):
            x = getattr(tr, name).clone()
            x[idx] = (x[idx] + 1) % q
            return tr.replace(**{name: x})
        return f
    return [("c", bump("c", (0, 0)), "fs_challenge"),
            ("u_1", bump("u_1", (0, 0)), "fs_all"),
            ("projection", bump("projection", (3,)), "fs_psi"),
            ("b_prime_prime", bump("b_prime_prime", (0, 1)), "fs_alpha")]


def test_fs_reports_cross_packages(fs_run):
    """JAX's fs_challenge_report and verify_fs accept the port's proof and
    reject its tampered copies; the port's do the same on the JAX proof
    and its copies, with the same report."""
    port = fs_run["port"]
    state, crs, jp = fs_run["state"], fs_run["crs"], fs_run["proof"]
    tp = port.proof
    jrep = jverifier.fs_challenge_report(P, state, _jax_transcript(tp), crs)
    assert all(bool(v) for v in jrep.values())
    assert jverifier.verify_fs(P, state, _jax_transcript(tp), crs)
    from labrador_tpu_torch import interop
    jp_port = interop.transcript_from_numpy(
        {n: np.asarray(getattr(jp, n)) for n in jp.__dataclass_fields__},
        "cpu")
    assert verifier.verify_fs(P, port.state, jp_port, port.crs)
    for name, tamper, check in _tampers(P.q):
        bad = tamper(tp)
        jrep = {k: bool(v) for k, v in jverifier.fs_challenge_report(
            P, state, _jax_transcript(bad), crs).items()}
        trep = verifier.fs_challenge_report(P, port.state, tamper(jp_port),
                                            port.crs)
        assert trep == jrep, name
        assert not trep[check] and not trep["fs_all"], name


def test_verify_fs_rejects_tampered(fs_run):
    """verify_fs (the 14 checks, b'' and FS) on tampered copies: a changed
    z fails the protocol checks with FS intact; a changed u1 fails both."""
    port = fs_run["port"]
    z = port.proof.z.clone()
    z[0, 3] = (z[0, 3] + 1) % P.q
    bad = port.proof.replace(z=z)
    assert verifier.fs_challenge_report(P, port.state, bad,
                                        port.crs)["fs_all"]
    assert not verifier.verify_fs(P, port.state, bad, port.crs)
    assert jverifier.verify_fs(P, fs_run["state"], _jax_transcript(bad),
                               fs_run["crs"]) is False


def test_fs_rejects_forged_challenge(fs_run):
    port = fs_run["port"]
    c = port.proof.c.clone()
    c[0, 0] = (c[0, 0] + 1) % P.q
    rep = verifier.fs_challenge_report(P, port.state, port.proof.replace(c=c),
                                       port.crs)
    assert not rep["fs_challenge"]


def test_fs_rejects_tampered_u1_derivation(fs_run):
    port = fs_run["port"]
    u1 = port.proof.u_1.clone()
    u1[0, 0] = (u1[0, 0] + 1) % P.q
    rep = verifier.fs_challenge_report(P, port.state,
                                       port.proof.replace(u_1=u1), port.crs)
    assert not rep["fs_all"] and not rep["fs_jl_matrix"]


def test_fs_deterministic(fs_run):
    port = fs_run["port"]
    again = prover.prove_fs(P, port.witness, port.state, port.crs)
    assert structs.transcript_sha256(again, P.q) == \
        structs.transcript_sha256(port.proof, P.q)


def test_fs_statement_binding(fs_run):
    """The proof under another statement (same witness and CRS) fails
    provenance from the first challenge on."""
    port = fs_run["port"]
    other = structs.generate_state(keys.key(4242), port.witness, P)
    rep = verifier.fs_challenge_report(P, other, port.proof, port.crs)
    assert not rep["fs_all"]
    assert not rep["fs_psi"] and not rep["fs_challenge"]


def test_fs_binds_crs_and_params(fs_run):
    """Another CRS seed, or another parameter set read on the same
    statement, gives another initial state."""
    from labrador_tpu_torch.oracle import FiatShamirOracle
    port = fs_run["port"]
    seed = FiatShamirOracle.create(port.crs.key, port.state, P).seed
    assert FiatShamirOracle.create((1, 2), port.state, P).seed != seed
    other_p = LabradorParams(n=2, r=2, kappa_override=16)
    assert FiatShamirOracle.create(port.crs.key, port.state,
                                   other_p).seed != seed


def test_interactive_and_fs_differ(fs_run):
    port = fs_run["port"]
    p1 = prover.prove(P, port.witness, port.state, port.crs, keys.key(3))
    assert not torch.equal(p1.c, port.proof.c)


def test_load_transcript_of_jax_file(fs_run, tmp_path):
    """A transcript the JAX package saved (small q: one member a field)
    reads back as the port's proof, dtypes included."""
    path = tmp_path / "jax_small.npz"
    jstructs.save_transcript(fs_run["proof"], str(path))
    got = structs.load_transcript(str(path), "cpu")
    for name in got.__dataclass_fields__:
        a, b = getattr(got, name), getattr(fs_run["port"].proof, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# big q
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_run():
    return run_flow(2, 2, 0, SEED, "cpu", big_q=True, fs=True)


def test_fs_jl_norm_wrap_rejected(big_run):
    """256 projection entries of 2^28: their squares sum to exactly 2^64,
    0 mod 2^64, under the bound; the per-entry precheck rejects them (the
    forgery of tests/test_bigq_pipeline.py)."""
    p = big_run.params
    forged = torch.full((256,), 1 << 28, dtype=torch.int64)
    bad = big_run.proof.replace(projection=forged)
    rep = verifier.fs_challenge_report(p, big_run.state, bad, big_run.crs)
    assert not rep["fs_jl_norm"]
    assert sum_sq_u64(forged) <= 128 * p.beta_bound * p.beta_bound
    assert big_run.ok and big_run.report["fs_jl_norm"]


def test_load_transcript_of_jax_big_q_file(big_run, tmp_path):
    """A big-q transcript written by the JAX package's save_transcript
    (two-limb fields as <name>__hi / <name>__lo, c signed) reads back as
    the port's."""
    tr = big_run.proof
    fields = {}
    for name in tr.__dataclass_fields__:
        a = getattr(tr, name).numpy()
        if name in ("pi", "c", "jl_ok", "b_pp_ok"):
            fields[name] = jnp.asarray(a if name != "c"
                                       else a.astype(np.int32))
        else:
            fields[name] = jzq.Zq2(jnp.asarray((a >> 16).astype(np.int32)),
                                   jnp.asarray((a & 0xFFFF).astype(np.int32)))
    path = tmp_path / "jax_big.npz"
    jstructs.save_transcript(jstructs.Transcript(**fields), str(path))
    got = structs.load_transcript(str(path), "cpu")
    for name in tr.__dataclass_fields__:
        a, b = getattr(got, name), getattr(tr, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name

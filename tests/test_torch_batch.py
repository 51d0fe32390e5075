"""Batched proving and verification in the port (``prover.prove_batch``,
``verifier.verify_report_batch``, the batch modes of the Ajtai, u1 and
C/D kernels, ``sampling.sample_challenges``) on the CPU, exactly (every
tolerance is 0):

* the batch plain versions of kernels 2-4 (a ``crs.CRSBatch``, operands
  with a leading instance axis) against per-instance plain calls at both
  moduli, whole and as range shards that compose to the whole;
* each against the JAX package's own route under ``jax.vmap`` over (B, 2)
  CRS keys (``protocol.ajtai_commit``, ``u1_from_digits``,
  ``u2_from_digits``, the XLA path) at config 1, B = 3;
* ``sample_challenges`` against ``jax.vmap(sampling.sample_challenge)``
  at both moduli, on keys whose rejection chains take different numbers
  of draws;
* ``prove_batch`` at config 1 of the seed-42 and seed-43 instances at
  both moduli and with both oracles: instance 0 equal to the JAX golden
  digest, instance 1 to the port's single prove, ``verify_report_batch``
  all true, and a tampered instance failing only its own row;
* refusals: a MaterializedCRS in a batch, operands without the instance
  axis, and the digit flag of a batch naming its instance.

On a CUDA machine, also each batch mode against its plain version.  JAX
runs only in a child process (``jax_side``), so on a card machine without
JAX ``python -m pytest tests/test_torch_batch.py -m cuda --noconftest``
runs the CUDA case."""

import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from labrador_tpu_torch import prover, structs, verifier
from labrador_tpu_torch import sampling as tsampling
from labrador_tpu_torch.cli import make_instance, make_params
from labrador_tpu_torch.crs import CRSBatch, MaterializedCRS
from labrador_tpu_torch.interop import key_from_words
from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
from labrador_tpu_torch.params import LabradorParams
from labrador_tpu_torch.protocol import AxisCtx, _stream_shard, _tri_stream

GOLDEN = Path(__file__).resolve().parent.parent / "labrador_tpu_torch" \
    / "golden"
Q_SMALL, Q_BIG = 8191, 4294967311
BIG = dict(q_start=(1 << 32) - 1, exact_digits=True)
B = 3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The port's CPU flows are many small torch ops: two intra-op
    threads keep them from stalling on the other test processes' threads
    when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Batch:
    """B instances' kernel operands at the shapes of ``p``, from a numpy
    seed: the witnesses, t digits and the g / h triangle streams, each
    with a leading instance axis, and the batch of B CRSs."""

    def __init__(self, p, seed: int, device="cpu"):
        rng = np.random.default_rng(seed)
        big = p.q > Q_SMALL
        self.p = p
        self.crs = CRSBatch.create(p, [seed + b for b in range(B)], device)

        def digits(base: int, shape):
            x = rng.integers(-(base // 2), base // 2 + 1, (B,) + shape)
            return x if big else x % p.q

        self.w_np = rng.integers(0, p.q, (B, p.r, p.n, p.d))
        self.t_np = digits(p.b_1, (p.t_1, p.r, p.kappa, p.d))
        self.g_np = digits(p.b_2, (p.t_2, p.r, p.r, p.d))
        self.h_np = digits(p.b_1, (p.t_1, p.r, p.r, p.d))
        t = functools.partial(_t, device=device)
        self.w, self.t_dig = t(self.w_np), t(self.t_np)
        self.g_str = _tri_stream(t(self.g_np), p)
        self.h_str = _tri_stream(t(self.h_np), p)


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def _small_params(q: int) -> LabradorParams:
    """n = r = 2 at kappa = 16 (kappa_1 = kappa_2 = 16)."""
    return LabradorParams(n=2, r=2, kappa_override=16,
                          **(BIG if q == Q_BIG else {}))


def _calls(x: Batch, plain: bool):
    """name -> fn(crs, instance operands or None for the batch's, range)
    of kernels 2-4, the range as the protocol's AxisCtx cuts it."""
    p = x.p
    aj = ajtai_cuda.ajtai_commit_plain if plain else ajtai_cuda.ajtai_commit
    u1 = u1_cuda.u1_bterm_plain if plain else u1_cuda.u1_bterm
    cd = cd_cuda.cd_sum_plain if plain else cd_cuda.cd_sum

    def pick(v, b):
        return v if b is None else v[b]

    def shard(n, i, total=None):
        per = p.kappa // n
        return (i * per, per) if total is None \
            else _stream_shard(total, AxisCtx(None, n, i))

    def cd_call(stream, off, t_used, base):
        def fn(crs, b, rng):
            extra = () if plain else (base,)
            if rng is None:
                return cd(crs, pick(stream, b), off, t_used, *extra)
            l0, m = shard(*rng, stream.shape[-3] * t_used)
            if plain:
                return cd(crs, pick(stream, b), off, t_used, l0, m)
            return cd(crs, pick(stream, b), off, t_used, base, l0, m)
        return fn

    return {
        "ajtai": lambda crs, b, rng: aj(crs, pick(x.w, b),
                                        *(() if rng is None else shard(*rng))),
        "u1": lambda crs, b, rng: u1(crs, pick(x.t_dig, b),
                                     *(() if rng is None else shard(*rng))),
        "u1_cterm": cd_call(x.g_str, x.crs._off_c, p.t_2, p.b_2),
        "u2": cd_call(x.h_str, x.crs._off_d, p.t_1, 0),
    }


@pytest.fixture(scope="module", params=[Q_SMALL, Q_BIG], ids=["small_q",
                                                               "big_q"])
def small_batch(request):
    return Batch(_small_params(request.param), 0xBA7C)


KERNELS = ["ajtai", "u1", "u1_cterm", "u2"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_batch_plain_matches_instances(small_batch, kernel):
    """The batch plain version of each kernel equals its per-instance plain
    calls, each instance with its own CRS."""
    x = small_batch
    fn = _calls(x, plain=True)[kernel]
    got = fn(x.crs, None, None)
    assert got.shape[0] == B
    for b in range(B):
        assert torch.equal(got[b], fn(x.crs[b], b, None))
    assert not torch.equal(got[0], got[1])


# kappa = 16 is cut into 2 or 4 rows; the C/D streams also into 3, unevenly
SHARD_CASES = [(k, n) for k in KERNELS for n in (2, 3, 4)
               if n != 3 or k.startswith("u1_") or k == "u2"]


@pytest.mark.parametrize("kernel, n_shards", SHARD_CASES)
def test_batch_plain_shards_compose(small_batch, kernel, n_shards):
    """As range shards (every instance the same range, as vmap inside
    shard_map): each shard equals its per-instance ranged calls, and the
    shards concatenated (Ajtai) or summed mod q (u1, C/D) equal the whole
    batch."""
    x, p = small_batch, small_batch.p
    fn = _calls(x, plain=True)[kernel]
    parts = []
    for i in range(n_shards):
        part = fn(x.crs, None, (n_shards, i))
        for b in range(B):
            assert torch.equal(part[b], fn(x.crs[b], b, (n_shards, i)))
        parts.append(part)
    whole = torch.cat(parts, -2) if kernel == "ajtai" \
        else sum(parts) % p.q
    assert torch.equal(whole, fn(x.crs, None, None))


# ---------------------------------------------------------------------------
# the JAX package's route under vmap, config 1
# ---------------------------------------------------------------------------

CHALLENGE_KEYS = 12


def _config1() -> Batch:
    return Batch(LabradorParams(n=2, r=2), 0xC1)


def _jax_side(out: str) -> None:
    """The JAX package's side, run in a fresh interpreter
    (``python tests/test_torch_batch.py --jax-side OUT``) and written to
    OUT (npz): its XLA route of Ajtai, u1 and u2 under ``jax.jit(jax.vmap)``
    over the (B, 2) CRS keys at config 1, and ``vmap(sample_challenge)`` of
    CHALLENGE_KEYS keys at both moduli with the keys' words.  A process of
    its own, so that none of these programs stays in the test worker, where
    the JAX package's own Pallas interpret-mode tests may run next."""
    import jax
    import jax.numpy as jnp

    from labrador_tpu import protocol, sampling
    from labrador_tpu.crs import CRS
    from labrador_tpu.ops import ntt
    from labrador_tpu.params import LabradorParams as Params

    x = _config1()
    p = Params(n=2, r=2)
    plan = ntt.plan_for(p)
    keys = jnp.asarray(np.asarray(x.crs.words, np.uint32))

    def crs(k):
        return CRS(key=k, params=p)

    def j32(a):
        return jnp.asarray(a, jnp.int32)

    res = {
        "ajtai": jax.jit(jax.vmap(lambda k, w: protocol.ajtai_commit(
            crs(k), ntt.ntt_fwd(w, plan), p, plan)))(keys, j32(x.w_np)),
        "u1": jax.jit(jax.vmap(lambda k, t, g: protocol.u1_from_digits(
            crs(k), t, g, p, plan)))(keys, j32(x.t_np), j32(x.g_np)),
        "u2": jax.jit(jax.vmap(lambda k, h: protocol.u2_from_digits(
            crs(k), h, p, plan)))(keys, j32(x.h_np)),
    }
    base = jax.random.key(77)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(CHALLENGE_KEYS))
    res["challenge_words"] = jax.random.key_data(jkeys)
    for q in (Q_SMALL, Q_BIG):
        jp = Params(n=2, r=2, **(BIG if q == Q_BIG else {}))
        res[f"challenges_{q}"] = jax.jit(jax.vmap(
            lambda k, jp=jp: sampling.sample_challenge(k, jp)))(jkeys)
    np.savez(out, **{k: np.asarray(v).astype(np.int64)
                     for k, v in res.items()})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """``_jax_side``'s results (JAX only in the child process)."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_side") / "jax_side.npz"
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, __file__, "--jax-side", str(out)], cwd=root,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(root)},
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def config1():
    return _config1()


@pytest.mark.parametrize("name", ["ajtai", "u1", "u2"])
def test_batch_plain_matches_jax_vmap(jax_side, config1, name):
    """Config 1, B = 3: Ajtai, u1 (B-term + C-term) and u2 of the batch
    plain versions equal the JAX package's vmapped commitments."""
    x, p = config1, config1.p
    if name == "ajtai":
        got = ajtai_cuda.ajtai_commit_plain(x.crs, x.w)
    elif name == "u1":
        got = (u1_cuda.u1_bterm_plain(x.crs, x.t_dig)
               + cd_cuda.cd_sum_plain(x.crs, x.g_str, x.crs._off_c,
                                      p.t_2)) % p.q
    else:
        got = cd_cuda.cd_sum_plain(x.crs, x.h_str, x.crs._off_d, p.t_1)
    np.testing.assert_array_equal(got.numpy(), jax_side[name])


# ---------------------------------------------------------------------------
# the lockstep challenge sampler
# ---------------------------------------------------------------------------

def _draws(key, p) -> int:
    """How many candidates the single-key chain of ``key`` draws."""
    from labrador_tpu_torch import keys as tkeys
    k, n = tkeys.fold_in(key, 0), 1
    while tsampling.challenge_rejected(tsampling._draw_challenge(k, p.d),
                                       p.d):
        k, n = tkeys.fold_in(k, 1), n + 1
    return n


@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG], ids=["small_q", "big_q"])
def test_sample_challenges_matches_jax_vmap(jax_side, q):
    """sample_challenges of CHALLENGE_KEYS keys equals
    jax.vmap(sample_challenge) row by row; the keys' chains take different
    numbers of draws, so the lockstep rounds keep accepted rows while
    others redraw."""
    tp = LabradorParams(n=2, r=2, **(BIG if q == Q_BIG else {}))
    tkeys = [key_from_words(w) for w in jax_side["challenge_words"]]
    assert len({_draws(k, tp) for k in tkeys}) > 1
    got = tsampling.sample_challenges(tkeys, tp, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jax_side[f"challenges_{q}"])
    one = tsampling.sample_challenge(tkeys[3], tp, device="cpu")
    assert torch.equal(one, got[3])


# ---------------------------------------------------------------------------
# prove_batch / verify_report_batch at config 1
# ---------------------------------------------------------------------------

def _golden(modulus: str, oracle: str) -> str:
    if oracle == "fs":
        return json.loads((GOLDEN / "config1_fs.json").read_text())[
            f"{modulus}_q"]["transcript_sha256"]
    if modulus == "big":
        return json.loads((GOLDEN / "config1_bigq.json").read_text())[
            "base"]["transcript_sha256"]
    return json.loads((GOLDEN / "config1.json").read_text())[
        "transcript_sha256"]


@functools.cache
def _proved(modulus: str, oracle: str):
    """The seed-42 and seed-43 config-1 instances, their batched proof and
    the single prove of the seed-43 instance (made once a process)."""
    p = make_params(2, 2, 0, False, modulus == "big")
    mode = "exact" if modulus == "big" else "reference"
    insts = [make_instance(p, s, "cpu") for s in (42, 43)]
    w = torch.stack([i[0] for i in insts])
    st = structs.stack([i[1] for i in insts])
    crs_b = CRSBatch.stack([i[2] for i in insts], device="cpu")
    tr = prover.prove_batch(p, w, st, crs_b, [i[3] for i in insts], oracle,
                            mode)
    w1, st1, crs1, kv1 = insts[1]
    one = prover.prove_fs(p, w1, st1, crs1, mode) if oracle == "fs" \
        else prover.prove(p, w1, st1, crs1, kv1, mode)
    return p, mode, st, crs_b, tr, one


@pytest.mark.parametrize("oracle", ["interactive", "fs"])
@pytest.mark.parametrize("modulus", ["small", "big"])
def test_prove_batch_matches_golden_and_single(modulus, oracle):
    p, mode, st, crs_b, tr, one = _proved(modulus, oracle)
    assert structs.transcript_sha256(structs.take(tr, 0), p.q) \
        == _golden(modulus, oracle)
    got = structs.take(tr, 1)
    for f in one.__dataclass_fields__:
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    rep = verifier.verify_report_batch(p, st, tr, crs_b, mode)
    assert all(v.shape == (2,) and bool(v.all()) for v in rep.values())


@pytest.mark.parametrize("modulus", ["small", "big"])
def test_verify_report_batch_tampered_row(modulus):
    """u_1[3, 5] + 1 in instance 1 fails check 19 in row 1 only; row 0
    equals the JAX package's report of instance 0 (its golden file)."""
    p, mode, st, crs_b, tr, _ = _proved(modulus, "interactive")
    u_1 = tr.u_1.clone()
    u_1[1, 3, 5] = (u_1[1, 3, 5] + 1) % p.q
    rep = verifier.verify_report_batch(p, st, tr.replace(u_1=u_1), crs_b,
                                       mode)
    assert rep["c19_u1"].tolist() == [True, False]
    assert rep["all"].tolist() == [True, False]
    assert bool(rep["c20_u2"].all())
    golden = json.loads((GOLDEN / ("config1_bigq.json" if modulus == "big"
                                   else "config1.json")).read_text())
    want = golden["base"]["verify_report"] if modulus == "big" \
        else golden["verify_report"]
    assert {k: bool(v[0]) for k, v in rep.items()} == want
    assert all(bool(v[1]) for k, v in rep.items()
               if k not in ("c19_u1", "all", "all_with_bpp"))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_materialized_crs_never_batched():
    p = _small_params(Q_SMALL)
    table = MaterializedCRS(coeffs=torch.zeros(8, dtype=torch.int32),
                            key=(1, 2), params=p)
    with pytest.raises(TypeError, match="never batched"):
        CRSBatch.stack([table], device="cpu")
    w = torch.zeros((1, p.r, p.n, p.d), dtype=torch.int64)
    st = structs.stack([structs.State(*(torch.zeros(1),) * 6)])
    with pytest.raises(TypeError, match="never batched"):
        prover.prove_batch(p, w, st, table, [None])
    with pytest.raises(TypeError, match="CRSBatch"):
        verifier.verify_report_batch(p, st, None, table)


def test_batch_shapes_refused():
    x = Batch(_small_params(Q_SMALL), 5)
    with pytest.raises(ValueError, match="batch of 3"):
        ajtai_cuda.ajtai_commit_plain(x.crs, x.w[0])
    with pytest.raises(ValueError, match="one CRS"):
        ajtai_cuda.ajtai_commit_plain(x.crs[0], x.w)
    with pytest.raises(ValueError, match="expected"):
        u1_cuda.u1_bterm_plain(x.crs, x.t_dig[:2])
    with pytest.raises(ValueError, match="batch of 3"):
        cd_cuda.cd_sum_plain(x.crs, x.h_str[0], x.crs._off_d, x.p.t_1)
    assert len(x.crs[1:]) == 2 and x.crs[1].key == x.crs.words[1]


def test_batch_digit_flag_names_instance():
    """A batch launch's flags, one an instance (CPU tensors here): the
    error names the first flagged instance and its digit."""
    p = _small_params(Q_SMALL)
    n_limbs = u1_cuda.digit_limbs(p.b_1)
    top = u1_cuda.limb_cover(n_limbs)
    digits = torch.zeros((3, 1, 4, p.d), dtype=torch.int64)
    digits[2, 0, 1, 7] = top + 1
    u1_cuda.raise_if_flagged(torch.zeros(3, dtype=torch.int32), digits, p.q,
                             n_limbs, batched=True)
    with pytest.raises(ValueError, match="beyond.*in instance 2"):
        u1_cuda.raise_if_flagged(torch.tensor([0, 0, 1], dtype=torch.int32),
                                 digits % p.q, p.q, n_limbs, batched=True)


# ---------------------------------------------------------------------------
# on a CUDA machine: each batch mode against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("q", [Q_SMALL, Q_BIG], ids=["small_q", "big_q"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_batch_modes_match_plain(q, kernel):
    """Whole and as shard 0 and 2 of 4, at kappa = 16 and config 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for p in (_small_params(q), LabradorParams(
            n=2, r=2, **(BIG if q == Q_BIG else {}))):
        x = Batch(p, 0xCA, "cuda")
        fn, plain = _calls(x, False)[kernel], _calls(x, True)[kernel]
        for rng in (None, (4, 0), (4, 2)):
            got = fn(x.crs, None, rng)
            assert torch.equal(got, plain(x.crs, None, rng)), (p.kappa, rng)
            for b in range(B):
                assert torch.equal(got[b], fn(x.crs[b], b, rng))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-side"] and len(sys.argv) == 3:
        _jax_side(sys.argv[2])
    else:
        sys.exit("usage: python tests/test_torch_batch.py --jax-side OUT.npz")

"""Phased and checkpointed proving in the port (``prover.prove_checkpointed``,
``utils/checkpoint.py``, ``utils/profiling.PhaseTimer``) on the CPU.

The phased proof is ``prove``'s, byte for byte, at small and big q, and
so is a proof resumed from a checkpoint saved after phase 1 or after
phase 2 (the run is stopped in the next phase, as a preempted job would
be).  No JAX: ``prove`` itself is held to the JAX package elsewhere
(tests/test_torch_e2e.py, tests/test_torch_bigq.py)."""

import numpy as np
import pytest
import torch

from labrador_tpu_torch import keys, prover, sampling, structs
from labrador_tpu_torch.cli import make_params
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.utils import checkpoint
from labrador_tpu_torch.utils.profiling import PhaseTimer

PHASES = ("p1_commitments", "p2_jl_aggregation_u2", "p3_opening")


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


def _instance(big_q: bool):
    p = make_params(2, 2, big_q=big_q)
    kw, ks, kv = keys.split(keys.key(11), 3)
    witness = sampling.generate_witness(kw, p, "cpu")
    state = structs.generate_state(ks, witness, p)
    crs = CRS.create(p, seed=0xC4)
    mode = "exact" if big_q else "reference"
    want = prover.prove(p, witness, state, crs, kv, mode)
    return dict(p=p, witness=witness, state=state, crs=crs, kv=kv,
                mode=mode, want=want)


@pytest.fixture(scope="module", params=["small_q", "big_q"])
def inst(request):
    return _instance(request.param == "big_q")


def _phased(inst, path=None, timer=None):
    return prover.prove_checkpointed(inst["p"], inst["witness"],
                                     inst["state"], inst["crs"], inst["kv"],
                                     path, inst["mode"], timer)


def _same(a: structs.Transcript, b: structs.Transcript, q: int) -> None:
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert structs.transcript_sha256(a, q) == structs.transcript_sha256(b, q)


def test_phased_equals_prove(inst):
    timer = PhaseTimer("cpu")
    _same(_phased(inst, timer=timer), inst["want"], inst["p"].q)
    assert tuple(timer.phases) == PHASES


class Preempted(Exception):
    pass


@pytest.mark.parametrize("stop_in,saved", [("prove_phase2a", 1),
                                           ("prove_phase3", 2)])
def test_resume_equals_prove(inst, stop_in, saved, tmp_path, monkeypatch):
    """Stopped in phase 2 (or 3), the run leaves a checkpoint of phase 1
    (or 2); the next run resumes there, runs only the phases after it and
    gives prove's bytes."""
    path = str(tmp_path / "ckpt.npz")
    real = getattr(prover, stop_in)

    def stop(*a, **k):
        raise Preempted

    monkeypatch.setattr(prover, stop_in, stop)
    with pytest.raises(Preempted):
        _phased(inst, path)
    monkeypatch.setattr(prover, stop_in, real)
    assert checkpoint.load_meta(path)["phases_done"] == saved
    assert sorted(checkpoint.load(path, "cpu")) == \
        ["ph1", "ph2"][:saved]

    ran = []
    for name in ("prove_phase1", "prove_phase2a", "prove_phase2b",
                 "prove_phase3"):
        fn = getattr(prover, name)
        monkeypatch.setattr(prover, name, lambda *a, _n=name, _f=fn, **k:
                            ran.append(_n) or _f(*a, **k))
    timer = PhaseTimer("cpu")
    _same(_phased(inst, path, timer), inst["want"], inst["p"].q)
    assert ran == ["prove_phase2a", "prove_phase2b", "prove_phase3"][
        2 * (saved - 1):]
    assert tuple(timer.phases) == PHASES[saved:]
    # the finished run left the phase-2 checkpoint, and a rerun resumes it
    assert checkpoint.load_meta(path)["phases_done"] == 2
    _same(_phased(inst, path), inst["want"], inst["p"].q)


def test_checkpoint_of_another_instance_refused(inst, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    _phased(inst, path)
    other = make_params(2, 2, kappa=16, big_q=inst["p"].q > 8191)
    with pytest.raises(ValueError, match="another instance"):
        prover.prove_checkpointed(other, inst["witness"], inst["state"],
                                  CRS.create(other, seed=1), inst["kv"],
                                  path, inst["mode"])


def test_checkpoint_round_trip(tmp_path):
    """Named dicts of int64, int8 and bool tensors and the JSON meta come
    back as saved; a save replaces the file whole."""
    path = str(tmp_path / "c.npz")
    rng = np.random.default_rng(0)
    a = {"t": torch.from_numpy(rng.integers(0, 1 << 40, (3, 4, 5))),
         "ok": torch.tensor(True)}
    b = {"pi": torch.from_numpy(rng.integers(-1, 2, (2, 7)).astype(np.int8))}
    assert not checkpoint.exists(path)
    checkpoint.save(path, meta={"phases_done": 1, "ost": None}, a=a)
    checkpoint.save(path, meta={"phases_done": 2, "x": [1, 2]}, a=a, b=b)
    assert checkpoint.exists(path)
    assert checkpoint.load_meta(path) == {"phases_done": 2, "x": [1, 2]}
    got = checkpoint.load(path, "cpu")
    for want, have in ((a, got["a"]), (b, got["b"])):
        assert set(want) == set(have)
        for k in want:
            assert have[k].dtype == want[k].dtype
            assert torch.equal(have[k], want[k])
    checkpoint.save(path, b=b)
    assert checkpoint.load_meta(path) == {}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]


def test_failed_save_keeps_previous_checkpoint(tmp_path, monkeypatch):
    """A save that fails part way leaves the previous file as it was and
    no temporary file beside it."""
    path = str(tmp_path / "c.npz")
    x = {"t": torch.arange(10)}
    checkpoint.save(path, meta={"phases_done": 1}, a=x)
    before = open(path, "rb").read()

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", broken)
    with pytest.raises(OSError):
        checkpoint.save(path, meta={"phases_done": 2}, a=x)
    assert open(path, "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]


def test_phase_timer_cpu():
    """Phases sum over repeats; the report lists them by time with a
    total."""
    timer = PhaseTimer("cpu")
    for _ in range(2):
        with timer.phase("a"):
            sum(range(20000))
    with timer.phase("b"):
        pass
    assert set(timer.phases) == {"a", "b"}
    assert timer.phases["a"] > 0 and timer.phases["b"] >= 0
    lines = timer.report().splitlines()
    assert lines[0].startswith("a: ") and lines[-1].startswith("total: ")
    assert len(lines) == 3


def test_phase_timer_defaults_to_cuda():
    """A timer made without a device syncs the card, as every entry point
    of the port defaults to it (its phases hold the queued device work);
    the CPU is asked for by name."""
    assert PhaseTimer().device == torch.device("cuda")
    assert PhaseTimer("cpu").device == torch.device("cpu")

"""The port's multi-device prover and verifier (``labrador_tpu_torch/
parallel/``) on the CPU, over gloo.

One world of 4 spawned CPU ranks (a FileStore under ``tmp_path``, one
torch thread a rank) runs every sharded case once for the module
(``_rank_cases``) and returns what each rank saw:

* the sharded prover on a (dp 2 x rows 2) and a (dp 1 x rows 4) mesh at
  config 1, interactive and Fiat-Shamir, at q = 8191 and q = 4294967311
  (kappa = 128).  Instance b of a batch is the CLI's instance at seed
  42 + b, so the two dp blocks prove different instances: the seed-42
  transcript equals its golden digest, the seed-43 one the digest of
  an unsharded prove of that instance;
* the sharded verifier's report equal to ``verifier.verify_report``'s on
  the valid proof and on one with u_1[3, 5] + 1, at both moduli;
* u2 over a rows group of 3 ranks (the C/D stream cut unevenly), equal to
  the unsharded u2, and a kappa that 3 rows do not divide refused;
* ``make_mesh`` refusing more ranks than the world holds, and the
  collectives gathering in rank order.

Without processes: the range modes' plain versions of kernels 2-4 for 1-4
shards at both moduli, concatenated (Ajtai) or summed mod q (u1, C/D),
equal to the unranged ones.  On a CUDA machine (``cuda``-marked; the
range modes themselves are held in ``tests/test_torch_cuda.py``), a
world of 4 ranks sharing cuda:0 proves config 1, 2^14 and 2^20 sharded
against single-rank runs on the card.

Parity with the JAX package comes from the golden files, which the JAX
package wrote (``labrador_tpu_torch/golden/``), and from
``tests/test_sharded.py``, which holds the JAX package's sharded prover
and verifier equal to its single-chip ones.  No JAX runs here.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from labrador_tpu_torch import protocol, prover, structs, verifier
from labrador_tpu_torch.cli import make_instance, make_params
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, cuda_lib, u1_cuda
from labrador_tpu_torch.params import LabradorParams

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "labrador_tpu_torch" / "golden"
WORLD = 4
SEED = 42
MESHES = [(2, 2), (1, 4)]
MODULI = ["small", "big"]
ORACLES = ["interactive", "fs"]
PROVE_CASES = [(m, o) for m in MODULI for o in ORACLES]
Q_SMALL, Q_BIG = 8191, 4294967311


def _golden_digest(modulus: str, oracle: str) -> str:
    if oracle == "fs":
        rec = json.loads((GOLDEN / "config1_fs.json").read_text())
        return rec[f"{modulus}_q"]["transcript_sha256"]
    if modulus == "big":
        rec = json.loads((GOLDEN / "config1_bigq.json").read_text())
        return rec["base"]["transcript_sha256"]
    return json.loads((GOLDEN / "config1.json").read_text())[
        "transcript_sha256"]


@functools.cache
def _instance(modulus: str, seed: int = SEED):
    """The CLI's config-1 instance at ``seed`` (42: the golden files'
    flow): params, witness, state, CRS, verifier key, decomposition mode
    (made once a process; nothing here writes to it)."""
    big = modulus == "big"
    p = make_params(2, 2, 0, False, big)
    witness, state, crs, kv = make_instance(p, seed, "cpu")
    return p, witness, state, crs, kv, "exact" if big else "reference"


def _tampered(proof, q: int):
    u_1 = proof.u_1.clone()
    u_1[3, 5] = (u_1[3, 5] + 1) % q
    return proof.replace(u_1=u_1)


def _rank_cases() -> dict:
    """Every sharded case, on one rank of the world (all ranks run the
    same collectives in the same order)."""
    import torch.distributed as dist

    from labrador_tpu_torch.parallel import multihost
    from labrador_tpu_torch.parallel.collectives import all_gather_cat
    from labrador_tpu_torch.parallel.mesh import make_mesh
    from labrador_tpu_torch.parallel.sharded import (make_sharded_prover,
                                                     make_sharded_verifier,
                                                     stack, take)

    rank = dist.get_rank()
    multihost.initialize("gloo")           # already initialized: a no-op
    out = {"rank": rank, "coordinator": multihost.is_coordinator()}
    meshes = {shape: make_mesh(*shape, device="cpu")
              for shape in MESHES + [(1, 3)]}
    try:
        make_mesh(2, 4, device="cpu")
    except ValueError as e:
        out["mesh_refused"] = str(e)

    mesh = meshes[(2, 2)]
    me = torch.tensor([[rank]])
    out["order"] = {
        "rows": all_gather_cat(me, 1, mesh.rows_group).tolist(),
        "dp": all_gather_cat(me == 1, 0, mesh.dp_group).tolist()}

    digests, proofs = {}, {}
    for (n_dp, n_rows) in MESHES:
        for modulus in MODULI:
            insts = [_instance(modulus, SEED + b) for b in range(n_dp)]
            p, mode = insts[0][0], insts[0][5]
            for oracle in ORACLES:
                fn = make_sharded_prover(p, meshes[(n_dp, n_rows)], mode,
                                         oracle)
                got = fn(torch.stack([i[1] for i in insts]),
                         stack([i[2] for i in insts]),
                         [i[3].key for i in insts], [i[4] for i in insts])
                digests[(n_dp, n_rows, modulus, oracle)] = [
                    structs.transcript_sha256(take(got, b), p.q)
                    for b in range(n_dp)]
                if (n_dp, n_rows, oracle) == (1, 4, "interactive"):
                    proofs[modulus] = take(got, 0)
    out["digests"] = digests

    # the sharded verifier on the (1 x 4) mesh
    cases = [(m, k) for m in MODULI for k in ("valid", "tampered")]
    reports, inputs = {}, {}
    for modulus, kind in cases:
        p, _, st, crs, _, mode = _instance(modulus)
        proof = proofs[modulus]
        if kind == "tampered":
            proof = _tampered(proof, p.q)
        vfn = make_sharded_verifier(p, meshes[(1, 4)], mode)
        reports[(modulus, kind)] = vfn(st, proof, crs.key)
        inputs[(modulus, kind)] = (p, st, proof, crs, mode)
    out["reports"] = reports

    # rows = 3: the C/D stream cut unevenly; kappa = 128 refused
    mesh3 = meshes[(1, 3)]
    p, w, st, crs, kv, mode = _instance("small")
    if mesh3.member:
        ctx = protocol.AxisCtx(mesh3.rows_group, 3, mesh3.row)
        h = torch.from_numpy(np.random.default_rng(3).integers(
            0, p.q, (p.r, p.r, p.d)))
        h_dig = protocol.decompose_h(h, p, mode)
        out["u2_rows3"] = torch.equal(
            protocol.u2_from_digits(crs, h_dig, p, ctx),
            protocol.u2_from_digits(crs, h_dig, p))
        for what, call in (
                ("prover", lambda: make_sharded_prover(p, mesh3)),
                ("ajtai", lambda: protocol.ajtai_commit(crs, w, ctx))):
            try:
                call()
            except ValueError as e:
                out[f"kappa_refused_{what}"] = str(e)

    # last, after every collective: the unsharded report of one verifier
    # case a rank, the four in parallel
    case = cases[rank % len(cases)]
    out["single_report"] = (case, verifier.verify_report(*inputs[case]))
    return out


def _single_digest(modulus: str, oracle: str) -> str:
    """The transcript digest of an unsharded prove of the seed-43
    instance (dp block 1 of the dp 2 x rows 2 batch)."""
    p, w, st, crs, kv, mode = _instance(modulus, SEED + 1)
    proof = (prover.prove(p, w, st, crs, kv, mode) if oracle == "interactive"
             else prover.prove_fs(p, w, st, crs, mode))
    return structs.transcript_sha256(proof, p.q)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results in rank order, and the unsharded digests of the
    seed-43 instance, which a thread of this process computes on one
    torch thread while the world runs."""
    from concurrent.futures import ThreadPoolExecutor

    from labrador_tpu_torch.parallel.multihost import spawn_local
    store = tmp_path_factory.mktemp("world")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as pool:
            singles = {case: pool.submit(_single_digest, *case)
                       for case in PROVE_CASES}
            ranks = spawn_local(_rank_cases, WORLD, threads=1,
                                timeout_s=300, store_dir=str(store))
            return ranks, {case: f.result() for case, f in singles.items()}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("modulus", MODULI)
@pytest.mark.parametrize("n_dp, n_rows", MESHES, ids=["dp2xrows2",
                                                      "dp1xrows4"])
def test_sharded_prover_matches_golden(runs, n_dp, n_rows, modulus,
                                       oracle):
    """Every rank returns the whole batch in dp order: instance 0 (seed
    42) equal to the JAX package's golden digest of the single-device
    flow, instance 1 (seed 43, dp block 1) to an unsharded prove's."""
    world, singles = runs
    want = [_golden_digest(modulus, oracle)]
    if n_dp == 2:
        assert singles[(modulus, oracle)] != want[0]
        want.append(singles[(modulus, oracle)])
    for res in world:
        assert res["digests"][(n_dp, n_rows, modulus, oracle)] == want, \
            res["rank"]


@pytest.mark.parametrize("kind", ["valid", "tampered"])
@pytest.mark.parametrize("modulus", MODULI)
def test_sharded_verifier_matches_single(world, modulus, kind):
    """The rows-sharded checks 15, 19 and 20 give verify_report's report
    on every rank; a tampered u_1 fails check 19 alone."""
    single = [r["single_report"][1] for r in world
              if r["single_report"][0] == (modulus, kind)]
    assert len(single) == 1
    for res in world:
        assert res["reports"][(modulus, kind)] == single[0]
    rep = single[0]
    if kind == "valid":
        assert all(rep.values())
    else:
        assert not rep["c19_u1"] and not rep["all"] and rep["c20_u2"]


def test_uneven_cd_split_over_three_ranks(world):
    """u2 with the (tri, k) stream cut over 3 ranks (L = 12: 4 a rank; the
    u1 C-term's L = 6 leaves the 4th rank of a rows-4 mesh none) equals
    the unsharded u2; rank 3 is beyond the 1 x 3 mesh."""
    assert [r.get("u2_rows3") for r in world] == [True, True, True, None]


def test_kappa_not_divided_refused(world):
    for res in world[:3]:
        for what in ("prover", "ajtai"):
            assert "must divide" in res[f"kappa_refused_{what}"]


def test_mesh_beyond_world_refused(world):
    for res in world:
        assert "needs more than 4 ranks" in res["mesh_refused"]


def test_collectives_keep_rank_order(world):
    """Rows groups gather their ranks in order ((0, 1) and (2, 3)), dp
    groups too ((0, 2), (1, 3)); bool tensors travel as uint8."""
    for res in world:
        r = res["rank"]
        assert res["order"]["rows"] == [[2 * (r // 2), 2 * (r // 2) + 1]]
        assert res["order"]["dp"] == [[r % 2 == 1], [r % 2 + 2 == 1]]
        assert res["coordinator"] == (r == 0)


def test_initialize_alone_is_a_world_of_one():
    """With no launcher's environment and no job named, ``initialize``
    joins a world of this process alone, and a mesh spans it."""
    import torch.distributed as dist

    from labrador_tpu_torch.parallel import multihost
    from labrador_tpu_torch.parallel.mesh import make_mesh
    assert not dist.is_initialized()
    multihost.initialize("gloo")
    try:
        mesh = multihost.global_mesh(device="cpu")
        assert (mesh.n_dp, mesh.n_rows, mesh.dp, mesh.row) == (1, 1, 0, 0)
        assert multihost.is_coordinator()
        with pytest.raises(ValueError, match="needs more than 1 ranks"):
            make_mesh(1, 2, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the range modes' plain versions, without processes
# ---------------------------------------------------------------------------

def _small_params(q: int) -> LabradorParams:
    """n = r = 2 at kappa = 16 (kappa_1 = kappa_2 = 16)."""
    if q == Q_SMALL:
        return LabradorParams(n=2, r=2, kappa_override=16)
    return LabradorParams(n=2, r=2, kappa_override=16, q_start=(1 << 32) - 1,
                          exact_digits=True)


@pytest.fixture(scope="module", params=[Q_SMALL, Q_BIG])
def unranged(request):
    """Random operands at q and the three kernels' unranged plain
    results."""
    q = request.param
    p = _small_params(q)
    crs = CRS.create(p, 0x5EED)
    rng = np.random.default_rng(q % 1009)

    def digits(base: int, shape):
        x = rng.integers(-(base // 2), base // 2 + 1, shape)
        return torch.from_numpy(x if q > Q_SMALL else x % q)

    w = torch.from_numpy(rng.integers(0, q, (p.r, p.n, p.d)))
    t_dig = digits(p.b_1, (p.t_1, p.r, p.kappa, p.d))
    g_str = protocol._tri_stream(digits(p.b_2, (p.t_2, p.r, p.r, p.d)), p)
    h_str = protocol._tri_stream(digits(p.b_1, (p.t_1, p.r, p.r, p.d)), p)
    return dict(p=p, crs=crs, w=w, t_dig=t_dig, g_str=g_str, h_str=h_str,
                ajtai=ajtai_cuda.ajtai_commit_plain(crs, w),
                u1=u1_cuda.u1_bterm_plain(crs, t_dig),
                c=cd_cuda.cd_sum_plain(crs, g_str, crs._off_c, p.t_2),
                d=cd_cuda.cd_sum_plain(crs, h_str, crs._off_d, p.t_1))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_ranged_plain_versions_compose(unranged, n_shards):
    """Shard by shard as protocol.AxisCtx cuts them: Ajtai's kappa rows
    concatenated, u1's kappa columns and the C/D stream slices summed mod
    q, equal the unranged results (kappa = 16 does not divide into 3: the
    stream slices still do, unevenly)."""
    u = unranged
    p, crs = u["p"], u["crs"]
    q = p.q
    ctxs = [protocol.AxisCtx(None, n_shards, i) for i in range(n_shards)]
    if p.kappa % n_shards == 0:
        rows = [protocol._kappa_shard(p.kappa, c) for c in ctxs]
        t = torch.cat([ajtai_cuda.ajtai_commit_plain(crs, u["w"], r0, n)
                       for r0, n in rows], 1)
        assert torch.equal(t, u["ajtai"])
        b = sum(u1_cuda.u1_bterm_plain(crs, u["t_dig"], c0, n)
                for c0, n in rows) % q
        assert torch.equal(b, u["u1"])
    for key, stream, off, t_used in (("c", u["g_str"], crs._off_c, p.t_2),
                                     ("d", u["h_str"], crs._off_d, p.t_1)):
        L = stream.shape[0] * t_used
        cuts = [protocol._stream_shard(L, c) for c in ctxs]
        assert sum(n for _, n in cuts) == L
        s = sum(cd_cuda.cd_sum_plain(crs, stream, off, t_used, l0, n)
                for l0, n in cuts) % q
        assert torch.equal(s, u[key])


def test_ranges_refused_outside(unranged):
    p, crs = unranged["p"], unranged["crs"]
    with pytest.raises(ValueError, match="outside A"):
        ajtai_cuda.ajtai_commit_plain(crs, unranged["w"], 12, 8)
    with pytest.raises(ValueError, match="outside B"):
        u1_cuda.u1_bterm_plain(crs, unranged["t_dig"], 16, 1)
    with pytest.raises(ValueError, match="outside the"):
        cd_cuda.cd_sum_plain(crs, unranged["h_str"], crs._off_d, p.t_1,
                             10, 100)


# ---------------------------------------------------------------------------
# on a CUDA machine: a world of 4 ranks sharing cuda:0 over gloo
# ---------------------------------------------------------------------------

# (cell, n, r, kappa, modulus, oracle, mesh (n_dp, n_rows)): config 1 on a
# dp 2 x rows 2 mesh against the golden digests, 2^14 (BASELINE.json
# config 3) on rows 4 and BASELINE.json config 4 (2^20, big q) on rows 2
# against single-rank runs on the card
CARD_RUNS = ([("config1", 2, 2, 0, m, o, (2, 2)) for m, o in PROVE_CASES]
             + [("2p14", 16, 16, 256, m, o, (1, 4)) for m, o in PROVE_CASES]
             + [("config4", 128, 128, 256, "big", "interactive", (1, 2))])


def _commit_launches() -> dict:
    """Launches so far of kernels 2-4 in each mode, by name."""
    return {v.name: v.launches for m in (ajtai_cuda, u1_cuda, cd_cuda)
            for v in vars(m).values() if isinstance(v, cuda_lib.KernelInfo)}


def _rank_card_runs() -> dict:
    """One rank of the world on the card: every run of CARD_RUNS on its
    mesh (ranks beyond a mesh skip its runs): this rank's launches of
    kernels 2-4 in the sharded prove, the batch's digests, and the
    sharded verifier's reports on the valid and the tampered proof
    (interactive runs beyond config 1)."""
    from labrador_tpu_torch.parallel.mesh import make_mesh
    from labrador_tpu_torch.parallel.sharded import (make_sharded_prover,
                                                     make_sharded_verifier,
                                                     stack, take)

    meshes = {shape: make_mesh(*shape, device="cuda")
              for shape in dict.fromkeys(run[-1] for run in CARD_RUNS)}
    out = {}
    for run in CARD_RUNS:
        cell, n, r, kappa, modulus, oracle, shape = run
        mesh = meshes[shape]
        if not mesh.member:
            continue
        p = make_params(n, r, kappa, False, modulus == "big")
        mode = "exact" if modulus == "big" else "reference"
        insts = [make_instance(p, SEED + b, mesh.device)
                 for b in range(mesh.n_dp)]
        fn = make_sharded_prover(p, mesh, mode, oracle)
        before = _commit_launches()
        tr = fn(torch.stack([i[0] for i in insts]),
                stack([i[1] for i in insts]), [i[2].key for i in insts],
                [i[3] for i in insts])
        torch.cuda.synchronize()
        res = {"launches": {k: v - before[k]
                            for k, v in _commit_launches().items()},
               "digests": [structs.transcript_sha256(take(tr, b), p.q)
                           for b in range(mesh.n_dp)]}
        if oracle == "interactive" and cell != "config1":
            vfn = make_sharded_verifier(p, mesh, mode)
            st, crs, proof = insts[0][1], insts[0][2], take(tr, 0)
            res["report"] = vfn(st, proof, crs.key)
            res["report_tampered"] = vfn(st, _tampered(proof, p.q), crs.key)
        out[run] = res
        del insts, tr
        torch.cuda.empty_cache()
    return out


def card_world(store_dir: str):
    """The single-rank references of CARD_RUNS on the card (config 1's
    instance 0: its golden digest), then the world's results in rank
    order (the ranks rendezvous through files in ``store_dir``)."""
    from labrador_tpu_torch.parallel.multihost import spawn_local

    refs = {}
    for run in CARD_RUNS:
        cell, n, r, kappa, modulus, oracle, (n_dp, _) = run
        p = make_params(n, r, kappa, False, modulus == "big")
        mode = "exact" if modulus == "big" else "reference"
        ref = refs[run] = {"digests": []}
        for b in range(n_dp):
            if cell == "config1" and b == 0:
                ref["digests"].append(_golden_digest(modulus, oracle))
                continue
            w, st, crs, kv = make_instance(p, SEED + b, "cuda")
            proof = (prover.prove(p, w, st, crs, kv, mode)
                     if oracle == "interactive"
                     else prover.prove_fs(p, w, st, crs, mode))
            ref["digests"].append(structs.transcript_sha256(proof, p.q))
            if oracle == "interactive" and cell != "config1":
                ref["report"] = verifier.verify_report(p, st, proof, crs,
                                                       mode)
                ref["report_tampered"] = verifier.verify_report(
                    p, st, _tampered(proof, p.q), crs, mode)
            del w, st, proof
        torch.cuda.empty_cache()
    cuda_lib.load()              # built here: the ranks load it
    ranks = spawn_local(_rank_card_runs, WORLD, threads=2, timeout_s=900,
                        store_dir=store_dir)
    return refs, ranks


def check_card_run(refs: dict, ranks: list, run) -> None:
    """Ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    device) at full width: every rank's transcripts equal the single-rank
    ones (config 1: instance 0's golden digest), its sharded verifier's
    reports too, a tampered u_1 failing check 19 alone; every rank
    launches the range modes of the run's modulus and no other mode."""
    ref, (n_dp, n_rows) = refs[run], run[-1]
    seen = [out[run] for out in ranks if run in out]
    assert len(seen) == n_dp * n_rows
    assert len(set(ref["digests"])) == n_dp
    ranged = [(m.KERNEL_RANGE_BIG if run[4] == "big" else m.KERNEL_RANGE).name
              for m in (ajtai_cuda, u1_cuda, cd_cuda)]
    for res in seen:
        assert res["digests"] == ref["digests"]
        launched = res["launches"]
        assert all(launched[k] for k in ranged), launched
        assert not any(n for k, n in launched.items() if k not in ranged), \
            launched
        if "report" in ref:
            assert res["report"] == ref["report"] and ref["report"]["all"]
            bad = res["report_tampered"]
            assert bad == ref["report_tampered"]
            assert not bad["c19_u1"] and not bad["all"] and bad["c20_u2"]


@pytest.fixture(scope="module")
def card_results(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return card_world(str(tmp_path_factory.mktemp("card")))


@pytest.mark.cuda
@pytest.mark.parametrize("run", CARD_RUNS, ids=[
    f"{c}-{m}-{o}-dp{s[0]}xrows{s[1]}" for c, *_, m, o, s in CARD_RUNS])
def test_card_world_matches_single_rank(card_results, run):
    """``check_card_run`` of each run of the world on the card."""
    check_card_run(*card_results, run)

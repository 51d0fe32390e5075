"""Multi-device prover and verifier over a (dp, rows) mesh.

Counterpart of ``labrador_tpu/parallel/sharded.py``:

  * ``dp``   splits a batch of independent proof instances: dp rank d
             proves the contiguous block d * B / n_dp .. (d + 1) * B / n_dp
             (the JAX package's ``P("dp")``) as one batch
             (``prover.prove_batch_impl``, its ``vmap``: each kernel
             launched once for the block), and the blocks' transcripts
             are gathered over dp in rank order, so every rank returns
             the whole batch.
  * ``rows`` splits the kappa-sized work of the three commitments: each
             rank runs the range mode of the Ajtai, u1 and C/D kernels
             over its share (``protocol.AxisCtx``) and one all-gather or
             all-reduce over its rows group completes the result.

There is one protocol implementation: these factories call
``prover.prove_batch_impl`` and ``verifier.verify_report`` with an
AxisCtx.
Everything not kappa-sized runs replicated on every rank of a rows group;
identical inputs and explicit keys make the replicas bit-identical, so
the transcripts equal the single-device prover's byte for byte, at both
moduli and with either oracle.  Where the JAX package's sharded branch
streams CRS tiles through XLA, each rank here runs the card's own kernels
over its range (their plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from ..crs import CRS, CRSBatch
from ..oracle import batch_oracles
from ..params import LabradorParams
from ..protocol import AxisCtx
from ..prover import prove_batch_impl
# stack and take batch and unbatch the instances ``make_sharded_prover``
# takes and returns; they live in structs beside the prover, which uses
# them too
from ..structs import State, Transcript, stack, take  # noqa: F401
from ..verifier import verify_report
from .collectives import all_gather_cat
from .mesh import Mesh


def _row_ctx(params: LabradorParams, mesh: Mesh) -> AxisCtx:
    """The AxisCtx of this rank's rows group; refuses a kappa that the
    rows axis does not divide and a rank beyond the mesh."""
    if params.kappa % mesh.n_rows:
        raise ValueError(f"kappa={params.kappa} must divide rows="
                         f"{mesh.n_rows}")
    if not mesh.member:
        raise ValueError("this rank is beyond the mesh")
    return AxisCtx(mesh.rows_group, mesh.n_rows, mesh.row, mesh.stats)


def _crs(params: LabradorParams, key) -> CRS:
    return CRS(key=(int(key[0]), int(key[1])), params=params)


def make_sharded_prover(params: LabradorParams, mesh: Mesh,
                        decomp_mode: str = "reference",
                        oracle: str = "interactive"):
    """Returns ``fn(witness (B, r, n, d), state (a State whose fields lead
    with B), crs_keys (B, 2), verifier_keys (B keys)) -> Transcript`` whose
    fields lead with B, the same on every rank of the mesh.  B is a
    multiple of the mesh's dp size.  ``oracle``: "interactive"
    (challenges from each instance's verifier key) or "fs" (SHA-256
    Fiat-Shamir; the verifier keys are ignored).  The inputs may lie on
    any device; each rank proves on the mesh's."""
    ctx = _row_ctx(params, mesh)
    if oracle not in ("interactive", "fs"):
        raise ValueError(f"unknown oracle {oracle!r}")

    def fn(witness_b: torch.Tensor, state_b: State, crs_keys,
           verifier_keys) -> Transcript:
        B = witness_b.shape[0]
        if B % mesh.n_dp:
            raise ValueError(f"batch {B} is not a multiple of dp="
                             f"{mesh.n_dp}")
        per = B // mesh.n_dp
        block = slice(mesh.dp * per, (mesh.dp + 1) * per)
        crs_b = CRSBatch.from_keys(params, list(crs_keys)[block], mesh.device)
        state = take(state_b, block, mesh.device)
        vkeys = None if verifier_keys is None \
            else list(verifier_keys)[block]
        orcs = batch_oracles(params, state, crs_b, vkeys, oracle)
        local = prove_batch_impl(params, witness_b[block].to(mesh.device),
                                 state, crs_b, orcs, decomp_mode, ctx)
        return Transcript(**{
            f.name: all_gather_cat(getattr(local, f.name), 0, mesh.dp_group,
                                   mesh.stats, "dp_gather")
            for f in dataclasses.fields(Transcript)})

    return fn


def make_sharded_verifier(params: LabradorParams, mesh: Mesh,
                          decomp_mode: str = "reference",
                          norm_mode: str = "exact"):
    """Returns ``fn(state, proof, crs_key) -> {check: bool}`` with checks
    15, 19 and 20 (the CRS re-expansions, the rayon-parallel site of
    ``verification.rs:372-415``) sharded over the rows axis.  State and
    proof are one instance, the same on every rank; every rank returns
    the report."""
    ctx = _row_ctx(params, mesh)

    def fn(state: State, proof: Transcript, crs_key) -> dict:
        return verify_report(params, take(state, None, mesh.device),
                             take(proof, None, mesh.device),
                             _crs(params, crs_key), decomp_mode, norm_mode,
                             ctx)

    return fn

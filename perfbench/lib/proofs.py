"""The base of a protocol module that makes one proof a step.

A traffic mix (``traffic/<mix>.json``) names its protocol, the module
``protocols/<protocol>.py``, whose ``make(config, mix, seed, device)``
gives the cell's traffic: an object with

* ``prove(step)`` and ``verify(step, proof, timer=None)``, the program's
  step; ``accepted(answer)``, whether a verdict accepts;
* ``reference_prove(step)`` and ``reference_verify(step, proof)``, the
  plain reference's, its verdict in the form of ``verify``'s;
* ``bincode(proof)`` and ``reference_bincode(proof)``, length and SHA-256
  of each side's serialised proof;
* ``differing(proof, ref)``, the parts of a proof that differ from the
  reference's, and ``tampered(proof)``, a proof an honest verifier
  rejects;
* ``statement(step)``, the statement a step proves (steps of one
  statement may repeat a proof).

``SingleProof`` gives all but the four calls of a step for a protocol
whose step is one transcript of ``labrador_tpu_torch.structs`` over a
pool of statements (``reference.instance``).  Each mix key that it reads:

* ``pool``: the statements under one CRS, proved in turn (step k proves
  statement k mod pool);
* ``check_sample``: how many of the window's steps, drawn from the seed,
  the reference recomputes (read by the runner);
* ``trace_steps``: the steps of a traced run's window under the profiler
  (read by the runner).

The statements are handed to the program and to the reference alike;
each side builds its own parameter set, CRS and keys from the same
numbers.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from ..reference import instance
from ..reference import structs as ref_structs


def derived_mismatch(params, stated: dict) -> dict:
    """The stated derived values (``derived`` of a configuration file)
    that ``params`` does not derive: {name: (stated, derived)}."""
    return {k: (v, getattr(params, k)) for k, v in stated.items()
            if getattr(params, k) != v}


class SingleProof:
    """A pool of statements on ``device``, one transcript a step."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from labrador_tpu_torch import structs
        from labrador_tpu_torch.crs import CRS
        from labrador_tpu_torch.params import LabradorParams

        self.mix = mix
        self.ref_params = instance.make_params(config)
        self.params = LabradorParams(**config["params"])
        for side, p in (("program", self.params),
                        ("reference", self.ref_params)):
            bad = derived_mismatch(p, config.get("derived", {}))
            if bad:
                raise ValueError(f"the {side} derives {bad}, not the "
                                 f"configuration's values")
        self.pool = instance.make_pool(self.ref_params, seed, mix["pool"],
                                       device)
        self.crs = CRS(key=self.pool.crs.key, params=self.params)
        self.states = [structs.State(**fields(s)) for s in self.pool.states]

    def statement(self, step: int) -> int:
        return step % len(self.states)

    @staticmethod
    def accepted(answer) -> bool:
        """A bool verdict, or a report whose verdict is under 'all'."""
        return bool(answer["all"] if isinstance(answer, dict) else answer)

    def bincode(self, proof) -> tuple[int, str]:
        """Length and SHA-256 of the program's bincode image of the proof
        without the fields a Fiat-Shamir verifier re-derives."""
        from labrador_tpu_torch import structs
        return digest(structs.bincode_chunks(proof, self.params.q, fs=True))

    def reference_bincode(self, proof) -> tuple[int, str]:
        return digest(ref_structs.bincode_chunks(
            self.reference_transcript(proof), self.ref_params.q, fs=True))

    @staticmethod
    def reference_transcript(proof):
        return ref_structs.Transcript(**fields(proof))

    @staticmethod
    def differing(proof, ref) -> list[str]:
        return differing_fields(proof, ref)

    def tampered(self, proof):
        """The proof with u_1[0, 0] raised by one mod q."""
        u_1 = proof.u_1.clone()
        u_1[0, 0] = (u_1[0, 0] + 1) % self.params.q
        return dataclasses.replace(proof, u_1=u_1)


def digest(chunks) -> tuple[int, str]:
    h, n = hashlib.sha256(), 0
    for blk in chunks:
        h.update(blk)
        n += len(blk)
    return n, h.hexdigest()


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def differing_fields(a, b) -> list[str]:
    """The fields of two transcripts whose tensors differ in shape, dtype
    or any value."""
    out = []
    for name, x in fields(a).items():
        y = getattr(b, name)
        if x.shape != y.shape or x.dtype != y.dtype \
                or not torch.equal(x, y.to(x.device)):
            out.append(name)
    return out

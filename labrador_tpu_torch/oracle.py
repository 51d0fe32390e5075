"""Challenge oracles.  Counterpart of ``labrador_tpu/oracle.py``; this slice
ports the interactive oracle (challenges from a verifier key, the
reference's model).  The prover threads an oracle state through
``absorb``/``challenge_key`` so the Fiat-Shamir oracle of a later slice
plugs in unchanged; the interactive oracle ignores it."""

from __future__ import annotations

from dataclasses import dataclass

from .keys import Key, fold_in

# absorption domains (message order), as in the JAX package
DOM_U1 = 2
DOM_JL = 3
DOM_BPP = 4
DOM_U2 = 5


@dataclass(frozen=True)
class InteractiveOracle:
    vkey: Key

    def init(self):
        return None

    def absorb(self, st, domain: int, arrays):
        return st

    def challenge_key(self, st, tag: int, idx: int = 0) -> Key:
        return fold_in(fold_in(self.vkey, tag), idx)

"""Challenge oracles: interactive and Fiat-Shamir.

The prover threads an oracle state through ``absorb`` / ``challenge_key``:

* ``InteractiveOracle``: challenges from a verifier key (the reference's
  model); the state is None and absorbing changes nothing.
* ``FiatShamirOracle``: challenges from a SHA-256 running hash of the
  protocol messages (FS_SPEC.md): the state is a 32-byte digest, each
  absorb hashes the domain tag, the state and the message words, and each
  challenge key is the full 256-bit digest of the state, tag and index,
  a ``keys.ShaKey``.

Messages are absorbed as the JAX package absorbs ``jax.tree.leaves`` of
them: at big q a residue tensor is its two ``Zq2`` limbs, ``x >> 16``
then ``x & 0xFFFF``; int8 tensors (the JL matrices) are one leaf.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .keys import Key, ShaKey, fold_in
from .sha import hash_arrays
from .zq import is_big

# absorption domains (message order), as in the JAX package
DOM_INIT = 1
DOM_U1 = 2
DOM_JL = 3
DOM_BPP = 4
DOM_U2 = 5
_DOM_KEY = 0xFF


@dataclass(frozen=True)
class InteractiveOracle:
    vkey: Key

    def init(self):
        return None

    def absorb(self, st, domain: int, arrays):
        return st

    def challenge_key(self, st, tag: int, idx: int = 0) -> Key:
        return fold_in(fold_in(self.vkey, tag), idx)


def leaves(arrays, q: int) -> list:
    """The JAX package's leaves of ``arrays`` at modulus q: at big q each
    residue tensor (every tensor but int8) as its limbs hi, lo."""
    out = []
    for a in arrays:
        if is_big(q) and a.dtype != torch.int8:
            out += [a >> 16, a & 0xFFFF]
        else:
            out.append(a)
    return out


@dataclass(frozen=True)
class FiatShamirOracle:
    seed: bytes     # the initial 32-byte state
    q: int

    @classmethod
    def create(cls, crs_key, state, params) -> "FiatShamirOracle":
        """The initial state binds the CRS key, the parameter set and the
        statement (every field of the State in order; FS_SPEC.md §2)."""
        p = params
        block = torch.tensor(
            [p.q & 0xFFFFFFFF, p.q >> 32, p.d, p.n, p.r, p.kappa, p.b, p.t_1,
             p.b_1, p.t_2, p.b_2, p.k_count, p.l_count], dtype=torch.int64)
        fields = [getattr(state, f.name) for f in dataclasses.fields(state)]
        return cls(seed=hash_arrays(torch.tensor(crs_key, dtype=torch.int64),
                                    block, *leaves(fields, p.q),
                                    domain=DOM_INIT), q=p.q)

    def init(self) -> bytes:
        return self.seed

    def absorb(self, st: bytes, domain: int, arrays) -> bytes:
        return hash_arrays(st, *leaves(arrays, self.q), domain=domain)

    def challenge_key(self, st: bytes, tag: int, idx: int = 0) -> ShaKey:
        return ShaKey(hash_arrays(st, torch.tensor([tag, idx]),
                                  domain=_DOM_KEY))

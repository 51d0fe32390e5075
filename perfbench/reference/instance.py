"""The statements a cell proves, made from the seed on the device.

A pool of statements under one Threefry CRS: statement i has the witness
of ``fold_in(kw, i)``, drawn as ``sampling.generate_witness`` draws it
(the program's and the JAX package's generator: a uniform draw shifted
into 30 bits, halved as a whole until its squared norm is at most
beta^2), and the random constraint families of ``fold_in(ks, i)`` that
the witness satisfies; (kw, ks, kv) = ``split(key(seed), 3)``.  Step k's
verifier key is ``fold_in(kv, k)``.  The CRS seed is the CLI's: seed *
0x9E3779B97F4A7C15 mod 2^64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import keys, sampling, structs
from .crs import CRS
from .params import LabradorParams

CRS_SEED_MULT = 0x9E3779B97F4A7C15


@dataclass
class Pool:
    params: LabradorParams
    crs: CRS
    witnesses: list[torch.Tensor]
    states: list[structs.State]
    vkey_base: keys.Key

    def verifier_key(self, step: int) -> keys.Key:
        return keys.fold_in(self.vkey_base, step)


def make_params(cfg: dict) -> LabradorParams:
    """The parameter set of a configuration file's ``params``."""
    return LabradorParams(**cfg["params"])


def make_pool(params: LabradorParams, seed: int, size: int,
              device) -> Pool:
    kw, ks, kv = keys.split(keys.key(seed), 3)
    witnesses, states = [], []
    for i in range(size):
        w = sampling.generate_witness(keys.fold_in(kw, i), params, device)
        witnesses.append(w)
        states.append(structs.generate_state(keys.fold_in(ks, i), w, params))
    crs = CRS.create(params, seed * CRS_SEED_MULT % 2**64)
    return Pool(params, crs, witnesses, states, kv)

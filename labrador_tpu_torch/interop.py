"""Carry the JAX package's objects into the port, as numpy arrays.

The caller converts with ``np.asarray`` (and ``jax.random.key_data`` for a
key); these functions build the port's objects from the arrays, so both
packages can be given the same instance.  The port never sees a JAX type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .crs import CRS
from .keys import Key
from .params import LabradorParams
from .structs import State, Transcript


def tensor(arr, device=None) -> torch.Tensor:
    """numpy array -> tensor (a copy): integer residues as int64, int8 and
    bool kept."""
    a = np.asarray(arr)
    if a.dtype not in (np.int8, np.bool_):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def key_from_words(words) -> Key:
    """A key from its two uint32 words (``jax.random.key_data(k)``)."""
    w = np.asarray(words, np.uint32).reshape(2)
    return Key(int(w[0]), int(w[1]))


def crs_from_words(words, params: LabradorParams) -> CRS:
    """A CRS from the JAX CRS's (2,) uint32 ``key`` array."""
    w = np.asarray(words, np.uint32).reshape(2)
    return CRS(key=(int(w[0]), int(w[1])), params=params)


def state_from_numpy(fields: dict, device=None) -> State:
    """A State from {field name: array} of a JAX ``State``."""
    return State(**{f.name: tensor(fields[f.name], device)
                    for f in dataclasses.fields(State)})


def transcript_from_numpy(fields: dict, device=None) -> Transcript:
    """A Transcript from {field name: array} of a JAX ``Transcript``."""
    return Transcript(**{f.name: tensor(fields[f.name], device)
                         for f in dataclasses.fields(Transcript)})

"""Explicit PRNG keys, stream-compatible with ``jax.random``.

The interactive verifier's challenges are drawn inside ``prove`` from keys
(``prover.py`` / ``oracle.py`` of the JAX package), so transcript parity
needs the same key streams, not just the same distributions.  This module
reproduces jax's default implementation, Threefry-2x32 with
``jax_threefry_partitionable=True`` (the jax 0.9 default):

* ``key(seed)``     -> words (seed >> 32, seed & 0xFFFFFFFF)
* ``split(k, num)`` -> key i = threefry(k, (i >> 32, i & 0xFFFFFFFF))
* ``fold_in(k, x)`` -> threefry(k, (0, x))
* ``bits(k, shape)``-> element i = x0 ^ x1 of threefry(k, (i >> 32, i & M))
* ``permutation``   -> one stable sort by fresh 32-bit keys per round
* ``bernoulli(p)``  -> float32 uniform (top 23 bits) compared with p

Key derivation runs on the host (a handful of blocks); ``bits`` runs on
whatever device it is asked for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .ops.prg import M32, threefry2x32


@dataclass(frozen=True)
class Key:
    """A Threefry key: two uint32 words (what ``jax.random.key_data``
    returns for a jax key)."""

    k0: int
    k1: int


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a nonnegative seed below 2**63."""
    if seed < 0:
        raise ValueError("seed must be nonnegative")
    return Key((seed >> 32) & M32, seed & M32)


def _block(k: Key, c0: int, c1: int) -> tuple[int, int]:
    x0, x1 = threefry2x32(k.k0, k.k1, torch.tensor([c0]), torch.tensor([c1]))
    return int(x0[0]), int(x1[0])


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` as a list of keys."""
    idx = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k.k0, k.k1, idx >> 32, idx & M32)
    return [Key(int(a), int(b)) for a, b in zip(x0.tolist(), x1.tolist())]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return Key(*_block(k, 0, int(data) & M32))


def bits(k: Key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2**32)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k.k0, k.k1, idx >> 32, idx & M32)
    return (x0 ^ x1).reshape(shape)


def bernoulli(k: Key, p: float, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` at float32: the uniform is the
    top 23 bits over 2**23, exactly representable, compared with
    float32(p)."""
    u = (bits(k, shape, device) >> 9).to(torch.float64) / float(1 << 23)
    return u < float(np.float32(p))


def permutation(k: Key, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(k, x)`` for a 1-D tensor: the rounds of
    ``jax._src.random._shuffle`` (each a split and a stable sort by fresh
    32-bit keys)."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    for _ in range(rounds):
        k, sub = split(k)
        sort_keys = bits(sub, (n,), x.device)
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x

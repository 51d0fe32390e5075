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

A ``ShaKey`` is the Fiat-Shamir oracle's 256-bit key, the JAX package's
SHA-256 PRNG impl (``ops/sha_prng.py``); ``split``, ``fold_in`` and
``bits`` dispatch on the key's type, so ``bernoulli``, ``permutation``
and the samplers take either key and draw what ``jax.random`` draws.

Key derivation runs on the host (a handful of blocks); ``bits`` runs on
whatever device it is asked for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .ops import sha_prng
from .ops.prg import M32, threefry2x32


@dataclass(frozen=True)
class Key:
    """A Threefry key: two uint32 words (what ``jax.random.key_data``
    returns for a jax key)."""

    k0: int
    k1: int


@dataclass(frozen=True)
class ShaKey:
    """A 256-bit key of the SHA-256 counter-mode streams: a 32-byte digest
    (what ``jax.random.key_data`` returns for a ``wrap_digest`` key, as
    big-endian words)."""

    digest: bytes


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a nonnegative seed below 2**63."""
    if seed < 0:
        raise ValueError("seed must be nonnegative")
    return Key((seed >> 32) & M32, seed & M32)


def _block(k: Key, c0: int, c1: int) -> tuple[int, int]:
    x0, x1 = threefry2x32(k.k0, k.k1, torch.tensor([c0]), torch.tensor([c1]))
    return int(x0[0]), int(x1[0])


def split(k, num: int = 2) -> list:
    """``jax.random.split(k, num)`` as a list of keys."""
    if isinstance(k, ShaKey):
        return [ShaKey(d) for d in sha_prng.split(k.digest, num)]
    idx = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k.k0, k.k1, idx >> 32, idx & M32)
    return [Key(int(a), int(b)) for a, b in zip(x0.tolist(), x1.tolist())]


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)``."""
    if isinstance(k, ShaKey):
        return ShaKey(sha_prng.fold_in(k.digest, int(data)))
    return Key(*_block(k, 0, int(data) & M32))


def bits(k, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2**32)."""
    return bits_stack([k], shape, device)[0]


def bits_stack(ks: list, shape, device="cuda") -> torch.Tensor:
    """``bits(k, shape)`` of each key of ``ks`` (all of one type), stacked:
    (len(ks),) + shape, drawn in one batch."""
    shape = tuple(shape)
    n = math.prod(shape)
    if all(isinstance(k, ShaKey) for k in ks):
        words = sha_prng.random_bits([k.digest for k in ks], n, device)
        return words.reshape((len(ks),) + shape)
    if len(ks) == 1:
        k0, k1 = ks[0].k0, ks[0].k1
    else:
        k0, k1 = (torch.tensor([[getattr(k, f)] for k in ks],
                               dtype=torch.int64, device=device)
                  for f in ("k0", "k1"))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (x0 ^ x1).reshape((len(ks),) + shape)


def bernoulli(k, p: float, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` at float32: the uniform is the
    top 23 bits over 2**23, exactly representable, compared with
    float32(p)."""
    u = (bits(k, shape, device) >> 9).to(torch.float64) / float(1 << 23)
    return u < float(np.float32(p))


def permutation(k, x: torch.Tensor) -> torch.Tensor:
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

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

Key derivation runs on the host in numpy (a handful of blocks,
``prg.threefry2x32_np``); ``bits`` runs on whatever device it is asked
for, small host draws in numpy too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .ops import sha_prng
from .ops.prg import M32, threefry2x32, threefry2x32_np


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


# host draws of at most this many blocks run in numpy (the challenge
# draws: 64 entries a key): below it a torch op's fixed cost is most of
# the time, above it torch's threads win
_NUMPY_BLOCKS = 1 << 14


def _words(ks: list) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry keys' words as (len(ks), 1) uint32 arrays (host)."""
    return tuple(np.array([[getattr(k, f)] for k in ks], dtype=np.uint32)
                 for f in ("k0", "k1"))


def split(k, num: int = 2) -> list:
    """``jax.random.split(k, num)`` as a list of keys."""
    if isinstance(k, ShaKey):
        return [ShaKey(d) for d in sha_prng.split(k.digest, num)]
    return split_stack([k], num)[0]


def split_stack(ks: list, num: int = 2) -> list:
    """``split(k, num)`` of each key of ``ks``, a list of lists; Threefry
    keys in one batch (the ``jax.vmap`` of ``split``)."""
    if not ks or not all(isinstance(k, Key) for k in ks):
        return [split(k, num) for k in ks]
    k0, k1 = _words(ks)
    idx = np.arange(num, dtype=np.uint64)
    x0, x1 = threefry2x32_np(k0, k1, idx >> 32, idx & M32)
    return [[Key(a, b) for a, b in zip(r0, r1)]
            for r0, r1 in zip(x0.tolist(), x1.tolist())]


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)``."""
    if isinstance(k, ShaKey):
        return ShaKey(sha_prng.fold_in(k.digest, int(data)))
    return fold_in_stack([k], data)[0]


def fold_in_stack(ks: list, data: int) -> list:
    """``fold_in(k, data)`` of each key of ``ks``; Threefry keys in one
    batch."""
    if not ks or not all(isinstance(k, Key) for k in ks):
        return [fold_in(k, data) for k in ks]
    k0, k1 = _words(ks)
    x0, x1 = threefry2x32_np(k0, k1, 0, int(data) & M32)
    return [Key(a, b) for a, b in zip(x0[:, 0].tolist(), x1[:, 0].tolist())]


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
    if torch.device(device).type == "cpu" and len(ks) * n <= _NUMPY_BLOCKS:
        k0, k1 = _words(ks)
        idx = np.arange(n, dtype=np.uint64)
        x0, x1 = threefry2x32_np(k0, k1, idx >> 32, idx & M32)
        return torch.from_numpy((x0 ^ x1).astype(np.int64)).reshape(
            (len(ks),) + shape)
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
    return bernoulli_stack([k], p, shape, device)[0]


def bernoulli_stack(ks: list, p: float, shape,
                    device="cuda") -> torch.Tensor:
    """``bernoulli(k, p, shape)`` of each key of ``ks``, stacked."""
    u = (bits_stack(ks, shape, device) >> 9).to(torch.float64) \
        / float(1 << 23)
    return u < float(np.float32(p))


def permutation(k, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(k, x)`` for a 1-D tensor: the rounds of
    ``jax._src.random._shuffle`` (each a split and a stable sort by fresh
    32-bit keys)."""
    return permutation_stack([k], x)[0]


def permutation_stack(ks: list, x: torch.Tensor) -> torch.Tensor:
    """``permutation(k, x)`` of the 1-D tensor x by each key of ``ks``:
    (len(ks), n), the sort keys of a round drawn in one batch."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    out = x.expand(len(ks), n)
    for _ in range(rounds):
        ks, subs = zip(*split_stack(list(ks)))
        sort_keys = bits_stack(list(subs), (n,), x.device)
        order = torch.sort(sort_keys, dim=-1, stable=True).indices
        out = torch.gather(out, 1, order)
    return out

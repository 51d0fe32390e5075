"""SHA-256 over 32-bit words (FIPS 180-4), for the Fiat-Shamir oracle.

Counterpart of ``labrador_tpu/ops/sha256.py``.  A message is a sequence of
uint32 words hashed as their big-endian bytes, with the standard padding
(bit length 32 * n_words), so every digest is plain SHA-256 of 4n bytes.
Two routes compute it:

* on the host, ``hashlib`` (``sha256_words``, ``hash_arrays``): every
  message hashed once, in series, however long (the transcript absorbs,
  the challenge keys, short key streams).  ``hash_arrays`` copies a
  tensor to the host once and widens it to words one chunk at a time;
* on any device, ``sha256_batch``: many independent messages of one
  length at once, each compress step a few torch ops over the batch (the
  plain route of ``sha_prng``'s long key streams, which a CUDA device
  hashes with the stream kernel, ``ops/sha_cuda``).  uint32 words are
  carried in int64 tensors and masked, as in ``ops/prg.py``.

Digests are 32-byte ``bytes``; ``digest_words`` gives their 8 words.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

M32 = 0xFFFFFFFF

K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

# elements widened to words per host chunk of hash_arrays
HOST_CHUNK = 1 << 22


def digest_words(digest: bytes) -> tuple[int, ...]:
    """The 8 big-endian uint32 words of a 32-byte digest."""
    return tuple(int(w) for w in np.frombuffer(digest, ">u4"))


def words_bytes(words) -> bytes:
    """Big-endian bytes of uint32 words (ints, or any integer array whose
    values lie in the int32 or the uint32 range)."""
    return (np.asarray(words, np.int64).reshape(-1) & M32).astype(
        ">u4").tobytes()


def sha256_words(words) -> bytes:
    """Digest of a uint32-word message (the JAX ``sha256_words``)."""
    return hashlib.sha256(words_bytes(words)).digest()


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().reshape(-1).cpu().numpy()
    return np.asarray(a).reshape(-1)


def hash_arrays(*arrays, domain: int = 0) -> bytes:
    """Digest of ``domain`` followed by each array's elements as words, the
    JAX ``hash_arrays``: int8 values sign-extended to int32, int32 and
    int64 values (in the int32 or the uint32 range) taken mod 2^32.  A
    32-byte digest among the arrays is its 8 words (an oracle state)."""
    h = hashlib.sha256(words_bytes([domain]))
    for a in arrays:
        if isinstance(a, bytes):
            if len(a) != 32:
                raise ValueError("a bytes argument must be a 32-byte digest")
            h.update(a)
            continue
        x = _host_array(a)
        if x.dtype == np.int8:
            for s in range(0, x.size, HOST_CHUNK):
                h.update(x[s:s + HOST_CHUNK].astype(">i4").tobytes())
        elif x.dtype in (np.int32, np.uint32, np.int64):
            if x.size and (int(x.min()) < -(1 << 31) or int(x.max()) > M32):
                raise ValueError(f"values outside 32 bits in a {x.dtype} "
                                 "array")
            for s in range(0, x.size, HOST_CHUNK):
                h.update(words_bytes(x[s:s + HOST_CHUNK]))
        else:
            raise TypeError(f"unhashable dtype {x.dtype}")
    return h.digest()


# ---------------------------------------------------------------------------
# The device route: a batch of messages, one torch op per step
# ---------------------------------------------------------------------------

def _rotr3(x, r0: int, r1: int, r2: int):
    """rotr(x, r0) ^ rotr(x, r1) ^ rotr(x, r2) of 32-bit words: the word
    doubled into 64 bits (x | x << 32, wrapping in int64) makes each
    rotation one shift; bits 0..31 of each shift come from bits below 63,
    so the arithmetic shift and the wrap never reach them."""
    xx = x | (x << 32)
    return ((xx >> r0) ^ (xx >> r1) ^ (xx >> r2)) & M32


def _sigma(x, r0: int, r1: int, s: int):
    """rotr(x, r0) ^ rotr(x, r1) ^ (x >> s) (the message schedule's)."""
    xx = x | (x << 32)
    return (((xx >> r0) ^ (xx >> r1)) & M32) ^ (x >> s)


def compress(state, block):
    """One SHA-256 compression: ``state`` 8 words and ``block`` 16 words,
    each a Python int or an int64 tensor of uint32 values (broadcast
    together), -> 8 words.  A rolling 16-word schedule: word i of the 64
    overwrites word i - 16."""
    w = list(block)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            j = i % 16
            w[j] = (w[j] + _sigma(w[(i - 15) % 16], 7, 18, 3)
                    + w[(i - 7) % 16] + _sigma(w[(i - 2) % 16], 17, 19, 10)
                    ) & M32
        t1 = h + _rotr3(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + K[i] \
            + w[i % 16]
        t2 = _rotr3(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + t2) & M32)
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_batch(words) -> list:
    """Digests of a batch of messages of one length: ``words`` lists the
    message's words in order, each a Python int (the same in every
    message) or an int64 tensor (one value per message, broadcast
    together).  Returns the 8 digest words, tensors of the batch's shape
    (ints where no word is a tensor)."""
    n = len(words)
    bitlen = 32 * n
    padded = list(words) + [0x80000000] + [0] * ((-(n + 3)) % 16) \
        + [(bitlen >> 32) & M32, bitlen & M32]
    state = list(H0)
    for s in range(0, len(padded), 16):
        state = compress(state, padded[s:s + 16])
    return state

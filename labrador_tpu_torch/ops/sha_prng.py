"""The SHA-256 counter-mode streams behind Fiat-Shamir challenge keys.

Counterpart of ``labrador_tpu/ops/sha_prng.py`` (FS_SPEC.md §5), without
its ``jax.random`` registration: ``keys.ShaKey`` holds the 256-bit key and
``keys`` dispatches on it.  With H = SHA-256 over big-endian 32-bit words
and K the key's 8 words:

  bits   : word stream w_j, block_j = H(K ‖ "BITS" ‖ j), j = 0, 1, ...
  fold_in: K' = H(K ‖ "FOLD" ‖ data)
  split  : K'_i = H(K ‖ "SPLT" ‖ i)

Only 32-bit draws exist here: every sampler of the protocol takes them.

Key derivations and short streams run on the host (``hashlib``).  A
stream of DEVICE_STREAM_BLOCKS blocks or more (the JL matrices) runs on
the caller's device as a batch of one-block messages: on a CUDA device in
one launch of the stream kernel (``ops/sha_cuda``), elsewhere through
``stream_plain`` (``sha256_batch``, STREAM_CHUNK_BLOCKS blocks at a time).
The route depends on the length and the device alone; every route gives
the same words.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from . import sha_cuda
from .sha256 import digest_words, sha256_batch, words_bytes

DOM_BITS = 0x42495453   # "BITS"
DOM_FOLD = 0x464F4C44   # "FOLD"
DOM_SPLT = 0x53504C54   # "SPLT"

# streams at least this long (in 8-word blocks, over all keys of a call)
# go to the device route.  The value is the plain route's break-even on an
# H100 host, whose ~3,000 torch ops a chunk take about 29 ms whatever the
# batch, against hashlib's 0.92 us a block (PERF.md §6).  On a CUDA device
# the stream kernel takes one launch, so its break-even lies lower; the
# short draws stay on the host until that is measured.
DEVICE_STREAM_BLOCKS = 1 << 15
# blocks per batched compress on the plain route: 8 state and 16 schedule
# words of int64 a block, 96 MiB of live tensors and their temporaries
STREAM_CHUNK_BLOCKS = 1 << 19


def derive(key: bytes, dom: int, word: int) -> bytes:
    """H(K ‖ dom ‖ word) of a 32-byte key (the JAX ``_h``)."""
    return hashlib.sha256(key + words_bytes([dom, word & 0xFFFFFFFF])
                          ).digest()


def fold_in(key: bytes, data: int) -> bytes:
    return derive(key, DOM_FOLD, data)


def split(key: bytes, num: int = 2) -> list[bytes]:
    return [derive(key, DOM_SPLT, i) for i in range(num)]


def stream_host(keys: list[bytes], n_words: int) -> np.ndarray:
    """(len(keys), n_words) uint32 stream words through hashlib."""
    nb = max(1, math.ceil(n_words / 8))
    out = np.empty((len(keys), nb * 8), np.uint32)
    for r, k in enumerate(keys):
        pre = k + words_bytes([DOM_BITS])
        out[r] = np.frombuffer(b"".join(
            hashlib.sha256(pre + j.to_bytes(4, "big")).digest()
            for j in range(nb)), ">u4")
    return out[:, :n_words]


def stream_device(keys: list[bytes], n_words: int,
                  device) -> torch.Tensor:
    """(len(keys), n_words) stream words as int64 on ``device``: each block
    one 10-word message K ‖ "BITS" ‖ j.  On a CUDA device every block of
    every key is hashed in one launch of the stream kernel; on any other
    device by ``stream_plain``."""
    if torch.device(device).type != "cuda":
        return stream_plain(keys, n_words, device)
    nb = max(1, math.ceil(n_words / 8))
    kw = torch.tensor([digest_words(k) for k in keys], dtype=torch.int64,
                      device=device)                           # (R, 8)
    return sha_cuda.sha_stream(kw, nb, DOM_BITS)[:, :n_words]


def stream_plain(keys: list[bytes], n_words: int,
                 device) -> torch.Tensor:
    """``stream_device``'s words by ``sha256_batch`` in torch ops on any
    device, in batches of STREAM_CHUNK_BLOCKS over the flat (key, block)
    index: the stream kernel's plain version."""
    nb = max(1, math.ceil(n_words / 8))
    total = len(keys) * nb
    kw = torch.tensor([digest_words(k) for k in keys], dtype=torch.int64,
                      device=device)                           # (R, 8)
    out = torch.empty((total, 8), dtype=torch.int64, device=device)
    for s in range(0, total, STREAM_CHUNK_BLOCKS):
        flat = torch.arange(s, min(total, s + STREAM_CHUNK_BLOCKS),
                            dtype=torch.int64, device=device)
        # one key: its words stay host ints, folded into the first rounds
        key_cols = list(digest_words(keys[0]) if len(keys) == 1
                        else kw[flat // nb].unbind(1))
        out[s:s + flat.numel()] = torch.stack(
            sha256_batch(key_cols + [DOM_BITS, flat % nb]), dim=1)
    return out.reshape(len(keys), nb * 8)[:, :n_words]


def random_bits(keys: list[bytes], n_words: int, device) -> torch.Tensor:
    """(len(keys), n_words) words of each key's stream (the JAX
    ``_random_bits`` at 32 bits) as int64 in [0, 2^32) on ``device``."""
    nb = max(1, math.ceil(n_words / 8))
    if len(keys) * nb >= DEVICE_STREAM_BLOCKS:
        return stream_device(keys, n_words, device)
    return torch.from_numpy(stream_host(keys, n_words).astype(
        np.int64)).to(device)

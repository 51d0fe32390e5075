"""SHA-256 for the Fiat-Shamir oracle, on the host through ``hashlib`` only.

Messages are uint32 words hashed as their big-endian bytes (FS_SPEC.md).
With H = SHA-256 and K a 32-byte key:

  bits   : word stream w_j, block_j = H(K ‖ "BITS" ‖ j), j = 0, 1, ...
  fold_in: K' = H(K ‖ "FOLD" ‖ data)
  split  : K'_i = H(K ‖ "SPLT" ‖ i)

Every stream, however long, is hashed block by block with ``hashlib``: the
reference takes no batched compress of its own.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
DOM_BITS = 0x42495453   # "BITS"
DOM_FOLD = 0x464F4C44   # "FOLD"
DOM_SPLT = 0x53504C54   # "SPLT"

# elements widened to words per host chunk of hash_arrays
HOST_CHUNK = 1 << 22


def words_bytes(words) -> bytes:
    """Big-endian bytes of uint32 words (values in the int32 or uint32
    range)."""
    return (np.asarray(words, np.int64).reshape(-1) & M32).astype(
        ">u4").tobytes()


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().reshape(-1).cpu().numpy()
    return np.asarray(a).reshape(-1)


def hash_arrays(*arrays, domain: int = 0) -> bytes:
    """Digest of ``domain`` followed by each array's elements as words:
    int8 values sign-extended to int32, int32 and int64 values (in the
    int32 or the uint32 range) taken mod 2^32; a 32-byte digest among the
    arrays is its 8 words (an oracle state)."""
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


def derive(key: bytes, dom: int, word: int) -> bytes:
    return hashlib.sha256(key + words_bytes([dom, word & M32])).digest()


def fold_in(key: bytes, data: int) -> bytes:
    return derive(key, DOM_FOLD, data)


def split(key: bytes, num: int = 2) -> list[bytes]:
    return [derive(key, DOM_SPLT, i) for i in range(num)]


def random_bits(keys: list[bytes], n_words: int, device) -> torch.Tensor:
    """(len(keys), n_words) words of each key's BITS stream as int64 in
    [0, 2^32) on ``device``."""
    nb = max(1, math.ceil(n_words / 8))
    out = np.empty((len(keys), nb * 8), np.uint32)
    for r, k in enumerate(keys):
        pre = k + words_bytes([DOM_BITS])
        out[r] = np.frombuffer(b"".join(
            hashlib.sha256(pre + j.to_bytes(4, "big")).digest()
            for j in range(nb)), ">u4")
    return torch.from_numpy(out[:, :n_words].astype(np.int64)).to(device)

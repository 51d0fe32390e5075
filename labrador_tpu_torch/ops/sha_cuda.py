"""The SHA-256 counter-mode stream of the Fiat-Shamir JL matrices: the CUDA
kernel (``csrc/sha_stream.cu``).

Replaces no Pallas kernel: the JAX package hashes in jnp ops.  One launch
hashes every block of every key of a call, one thread a message, where the
plain route (``sha_prng.stream_plain``: ``sha256_batch``, a torch op per
step of the compress function) takes about 3,000 launches a chunk.
``sha_prng.stream_device`` launches it for CUDA tensors and takes the
plain route on every other device.
"""

from __future__ import annotations

import torch

from . import cuda_lib

KERNEL = cuda_lib.KernelInfo(
    name="sha_stream",
    source="labrador_tpu_torch/csrc/sha_stream.cu",
    replaces="none (labrador_tpu/ops/sha256.py hashes in jnp ops)")

MAX_KEYS = 65535          # grid.y of the launch
MAX_BLOCKS = 1 << 32      # the block index is one 32-bit message word


def sha_stream(key_words: torch.Tensor, nb: int, dom: int) -> torch.Tensor:
    """(R, nb * 8) int64 words in [0, 2^32): row r holds the digests of the
    messages K_r ‖ dom ‖ j, j = 0 .. nb - 1, in order, K_r the 8 words of
    ``key_words[r]`` ((R, 8) int64 values in [0, 2^32) on a CUDA device)."""
    n_keys = key_words.shape[0]
    cuda_lib.require_cuda_operand(key_words, "key_words", (n_keys, 8))
    if key_words.data_ptr() % 16:
        raise ValueError("key_words must be 16-byte aligned")
    if not 1 <= n_keys <= MAX_KEYS or not 1 <= nb <= MAX_BLOCKS:
        raise ValueError(f"{n_keys} keys of {nb} blocks beyond the stream "
                         f"kernel's 1..{MAX_KEYS} keys of 1..{MAX_BLOCKS}")
    out = torch.empty((n_keys, nb * 8), dtype=torch.int64,
                      device=key_words.device)
    err = cuda_lib.load().lib.sha_stream_launch(
        key_words.data_ptr(), out.data_ptr(), n_keys, nb, dom,
        cuda_lib.stream_ptr(key_words.device))
    cuda_lib.check(err)
    KERNEL.launches += 1
    return out

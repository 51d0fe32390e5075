"""The host's Threefry-2x32 in numpy (``ops.prg.threefry2x32_np``, which
the keys' derivations and the small host draws run) against the torch
version that every other draw runs: the same words, and the keys' split,
fold_in and bits the same on either path.  No JAX: the torch version is
held to ``jax.random`` in tests/test_torch_ops.py."""

import numpy as np
import pytest
import torch

from labrador_tpu_torch import keys
from labrador_tpu_torch.ops.prg import M32, threefry2x32, threefry2x32_np

KEYS = [(0, 0), (M32, M32), (0x9E3779B9, 0x7F4A7C15), (1, M32 - 1)]


@pytest.mark.parametrize("k", KEYS)
@pytest.mark.parametrize("start", [0, M32 - 40, (1 << 40) + 3])
def test_numpy_block_equals_torch(k, start):
    idx = torch.arange(start, start + 64, dtype=torch.int64)
    want = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
    nidx = idx.numpy().astype(np.uint64)
    got = threefry2x32_np(k[0], k[1], nidx >> 32, nidx & M32)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w.numpy())


def test_numpy_key_rows_broadcast_as_torch():
    k0 = np.array([[a] for a, _ in KEYS], dtype=np.uint32)
    k1 = np.array([[b] for _, b in KEYS], dtype=np.uint32)
    want = threefry2x32(torch.from_numpy(k0.astype(np.int64)),
                        torch.from_numpy(k1.astype(np.int64)),
                        torch.zeros(1, dtype=torch.int64),
                        torch.tensor([M32 - 2]))
    got = threefry2x32_np(k0, k1, 0, M32 - 2)
    for g, w in zip(got, want):
        assert g.shape == (len(KEYS), 1) and np.array_equal(g, w.numpy())


@pytest.mark.parametrize("num", [1, 2, 5])
def test_split_and_fold_in_equal_the_torch_blocks(num):
    k = keys.Key(*KEYS[2])
    idx = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k.k0, k.k1, idx >> 32, idx & M32)
    assert keys.split(k, num) == [keys.Key(a, b) for a, b in
                                  zip(x0.tolist(), x1.tolist())]
    y0, y1 = threefry2x32(k.k0, k.k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([num]))
    assert keys.fold_in(k, num) == keys.Key(int(y0[0]), int(y1[0]))


@pytest.mark.parametrize("shape", [(64,), (3, 5), (keys._NUMPY_BLOCKS,),
                                   (keys._NUMPY_BLOCKS + 1,)])
def test_host_bits_equal_the_torch_path(shape):
    """``bits_stack`` on the host, in numpy up to _NUMPY_BLOCKS blocks and
    in torch above, equals the torch blocks of its keys."""
    ks = [keys.Key(*k) for k in KEYS[:2]]
    got = keys.bits_stack(ks, shape, device="cpu")
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64)
    for i, k in enumerate(ks):
        x0, x1 = threefry2x32(k.k0, k.k1, idx >> 32, idx & M32)
        assert got.dtype == torch.int64
        assert torch.equal(got[i], (x0 ^ x1).reshape(shape))

"""The ChaCha20-compatible CRS coefficient generator (``chacha_compat.cpp``),
built with g++ and loaded with ctypes.

Counterpart of ``labrador_tpu/native/``.  The build runs at first use, from
the source in this directory only, into
``labrador_tpu_torch/_build/chacha-<hash>/`` keyed by a hash of the source
and the flags (as ``ops/cuda_lib.py`` builds the CUDA library), so an
edited source rebuilds and nothing is written beside the source.  Nothing
here runs at import time.  ``crs_coeffs`` splits a long range over host
threads: ctypes releases the GIL for the duration of each call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "chacha_compat.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# coefficients a thread takes at least (one ChaCha20 block each)
_MIN_PER_THREAD = 1 << 16


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    out_dir = BUILD_ROOT / f"chacha-{source_hash()}"
    so = out_dir / "libchacha_compat.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so",
                                         delete=False) as tmp:
            tmp_path = tmp.name
        cmd = [shutil.which("g++") or "g++", *GXX_FLAGS, "-o", tmp_path,
               str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp_path)
            raise RuntimeError("g++ failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp_path, so)       # atomic: a concurrent build just redoes
    lib = ctypes.CDLL(str(so))
    lib.crs_coeffs.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_uint64, ctypes.c_uint64,
                               ctypes.c_void_p]
    lib.crs_coeffs.restype = None
    lib.chacha20_keystream.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_void_p]
    lib.chacha20_keystream.restype = None
    return lib


def crs_coeffs(base_seed: bytes, offset: int, count: int,
               q: int) -> np.ndarray:
    """Reference-compatible CRS coefficients (int64, in [0, q)):
    coefficient i is drawn from a fresh ChaCha20Rng seeded with base_seed
    + offset + i (big-endian), exactly like ``CRS::generate_random_coeff``
    (``structs.rs:167-171``).  The host's cores share the range, each
    taking at least _MIN_PER_THREAD coefficients."""
    if len(base_seed) != 32:
        raise ValueError("base_seed must be 32 bytes")
    lib = load()
    out = np.zeros(count, np.int64)
    threads = max(1, min(os.cpu_count() or 1, count // _MIN_PER_THREAD))
    step = max(1, -(-count // threads))

    def run(lo: int) -> None:
        lib.crs_coeffs(base_seed, offset + lo, min(step, count - lo), q,
                       out.ctypes.data + 8 * lo)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(run, range(0, count, step)))
    return out


def chacha20_keystream(key: bytes, counter: int = 0) -> np.ndarray:
    """One raw ChaCha20 block (16 uint32 words), for test vectors."""
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    out = np.zeros(16, np.uint32)
    load().chacha20_keystream(key, counter, out.ctypes.data)
    return out

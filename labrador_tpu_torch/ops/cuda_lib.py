"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

``nvcc`` compiles the sources for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes`` (seconds to build; no PyTorch
headers).  The build runs at first use, from the sources in the package
only, into ``labrador_tpu_torch/_build/<hash>/`` keyed by a hash of the
sources and flags, so an edited source rebuilds.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# C entry points (csrc/*.cu) and their argument types; each returns the
# cudaError_t of its launches.
_SIGNATURES = {
    "ajtai_commit_launch": (_P, _P, _P, _I, _I, _I, _I64, _U64, _U32, _U32, _I,
                            _I, _I, _I, _I, _P),
    "u1_bterm_launch": (_P, _P, _P, _P, _I, _I, _I, _I64, _U64, _U64, _U32,
                        _U32, _I, _I, _I, _I, _I, _P),
    "cd_sum_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I64, _U64, _U64, _U32,
                      _U32, _I, _I, _I, _I, _I, _P),
    "polymul_coef_launch": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                            _I64, _I, _U32, _U32, _U64, _P),
    "polymul_bhat_launch": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                            _P),
    "cuda_error_string": (_I,),
}


@dataclass
class KernelInfo:
    """One ported kernel: its source, the Pallas kernel it replaces, and a
    count of launches (incremented by the wrapper where it launches)."""

    name: str
    source: str
    replaces: str
    launches: int = 0


@dataclass
class _Loaded:
    lib: ctypes.CDLL
    ptxas_log: str      # nvcc's -Xptxas -v report ("" when loaded cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load() -> _Loaded:
    """Build (if needed) and load the kernel library, once per process."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "liblabrador_kernels.so"
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
        with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so",
                                         delete=False) as tmp:
            tmp_path = tmp.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp_path)
            raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
        log = proc.stdout + proc.stderr
        os.replace(tmp_path, so)       # atomic: a concurrent build just redoes
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_char_p if fn == "cuda_error_string" else _I
    return _Loaded(lib, log)


def check(err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        msg = load().lib.cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_operand(x: torch.Tensor, name: str, shape,
                         dtype=torch.int64) -> None:
    """Validate a kernel operand: CUDA, dtype, shape and contiguity."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

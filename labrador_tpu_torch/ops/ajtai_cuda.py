"""Ajtai commitment t = A s: the CUDA kernel (``csrc/ajtai.cu``) and its
plain PyTorch version.

Replaces ``labrador_tpu/ops/ajtai_pallas.py`` (``ajtai_commit_pallas``),
both its branches: small q, and the 2^32-scale modulus (``big`` in the
Pallas kernel, ``circulant_limbs_big``), whose launches count in
``KERNEL_BIG``.  A is the virtual CRS matrix (kappa, n, d) at offset
row * n * d; it is expanded in the kernel and never stored.  The kernel
takes the products on int8 tensor cores: CRS entries as
``entry_limbs(q)`` unsigned 8-bit limbs, the centred witness as
``witness_limbs(q)`` signed ones, each entry generated once per block and
applied to the block's ``rhs_group`` witness vectors (``launch_shape``).
The range mode (``rows`` given) computes the rows row0 .. row0 + rows - 1
of A only, one shard of the kappa axis on a (dp, rows) mesh; its launches
count in ``KERNEL_RANGE`` / ``KERNEL_RANGE_BIG``.  For a
``crs.MaterializedCRS`` the kernel reads A from its table (the table mode,
small q only, whole and ranged, launches counted in ``KERNEL_TABLE``);
a Threefry ``crs.CRS`` takes the modes above (``ring_stream.entry_table``
decides, and raises for anything else).  For a ``crs.CRSBatch`` of B
Threefry CRSs the witness leads with B and the batch mode commits every
instance in one launch (each with its own key; launches counted in
``KERNEL_BATCH`` / ``KERNEL_BATCH_BIG``, or in the range infos with
``rows``, since the range is the mode of a sharded prove).  The wrapper
launches the kernel for CUDA tensors and takes the plain version only
for CPU tensors.
"""

from __future__ import annotations

import functools
import sys

import torch

from . import cuda_lib
from .ring_stream import (barrett_m, check_big_operand, check_q,
                          device_keys, entry_table, instances,
                          ring_stream_plain)
from .zq import is_big

KERNEL = cuda_lib.KernelInfo(
    name="ajtai_commit",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:234")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="ajtai_commit_bigq",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:173")
KERNEL_RANGE = cuda_lib.KernelInfo(
    name="ajtai_commit_range",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:234")
KERNEL_RANGE_BIG = cuda_lib.KernelInfo(
    name="ajtai_commit_range_bigq",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:173")
KERNEL_TABLE = cuda_lib.KernelInfo(
    name="ajtai_commit_table",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:234")
KERNEL_BATCH = cuda_lib.KernelInfo(
    name="ajtai_commit_batch",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:234")
KERNEL_BATCH_BIG = cuda_lib.KernelInfo(
    name="ajtai_commit_batch_bigq",
    source="labrador_tpu_torch/csrc/ajtai.cu",
    replaces="labrador_tpu/ops/ajtai_pallas.py:173")

# The kernel's limbs, modes and launch constants (csrc/ajtai.cu).
SMALL_LIMBS = 2        # entries below q <= 32513; witness |x| <= q/2
BIG_ENTRY_LIMBS = 5    # residues below q < 2^33: four bytes, the top bit
BIG_WITNESS_LIMBS = 5  # |x| <= q/2 < 2^32: four signed limbs stop below
FLUSH_L = 128          # ring elements a warp adds between int32 flushes
_SMS = 132             # the H100's SMs


def entry_limbs(q: int) -> int:
    """Unsigned 8-bit limbs of a CRS entry (a residue in [0, q))."""
    return BIG_ENTRY_LIMBS if is_big(q) else SMALL_LIMBS


def witness_limbs(q: int) -> int:
    """Signed 8-bit limbs of a centred witness coefficient (|x| <= q/2)."""
    return BIG_WITNESS_LIMBS if is_big(q) else SMALL_LIMBS


def chunk(q: int) -> int:
    """Ring elements per shared-memory chunk (AjtaiMode::LC)."""
    return 4 if is_big(q) else 8


def m_tiles(q: int) -> int:
    """16-coefficient m-tiles per warp (AjtaiMode::MT): the 4 of one
    witness vector at small q, 1 at big q (9 limb weights of sums)."""
    return 1 if is_big(q) else 4


def max_warps(q: int) -> int:
    """Warps per block at most (AjtaiMode::WARPS)."""
    return 16 if is_big(q) else 8


@functools.lru_cache(maxsize=256)
def launch_shape(rows: int, nrhs: int, L: int, q: int,
                 instances: int = 1) -> tuple[int, int, int, int, int]:
    """(row_tiles, rhs_group, l_groups, splits, ring elements per split) of
    a launch: blocks of up to ``max_warps(q)`` warps, each one 8-row tile,
    one witness vector and ``m_tiles(q)`` m-tiles; ``rhs_group`` vectors
    per block (as many as fit: each CRS entry serves all of them), then
    ``row_tiles`` tiles, the rest of the warps as ``l_groups`` that split
    each chunk's ring elements (r_eff = 1 on few rows).  The blocks of a
    batch's ``instances`` count first, then the l stream is split over
    grid.x by ``_splits`` to fill the card; the row tiles per block are
    halved while the grid cannot fill it (a short stream: more blocks,
    each generating fewer entries)."""
    ms = 4 // m_tiles(q)
    lc, top = chunk(q), max_warps(q)
    group = max(1, min(nrhs, top // ms))
    tiles = -(-rows // 8)
    chunks = -(-L // lc)
    row_tiles = max(1, min(tiles, top // (ms * group)))
    while True:
        l_groups = top // (ms * group * row_tiles)
        warps = ms * group * row_tiles * l_groups
        blocks = -(-tiles // row_tiles) * -(-nrhs // group) * instances
        # blocks resident at once: 16 warps per SM (csrc/ajtai.cu)
        resident = _SMS * (16 // warps)
        if row_tiles == 1 or blocks * chunks >= resident:
            splits, per = _splits(blocks, chunks, resident)
            return row_tiles, group, l_groups, splits, per * lc
        row_tiles = 1 << ((row_tiles - 1).bit_length() - 1)


def _splits(blocks: int, chunks: int, resident: int) -> tuple[int, int]:
    """(splits, chunks per split) of a stream of ``chunks`` chunks over
    ``blocks`` blocks a split, ``resident`` blocks running at once: the
    least waves x (chunks per block + 1/2, its set-up and write-out), so
    that a last wave of a few blocks does not double the time; fewer
    splits on a tie."""
    best = None
    for s in range(1, min(chunks, 65535) + 1):
        per = -(-chunks // s)
        s_eff = -(-chunks // per)
        waves = -(-blocks * s_eff // resident)
        cost = waves * (2 * per + 1)
        if best is None or cost < best[0]:
            best = (cost, s_eff, per)
    return best[1], best[2]


def ajtai_commit(crs, witness: torch.Tensor, row0: int = 0,
                 rows: int | None = None) -> torch.Tensor:
    """t (r_eff, kappa, d) mod q for witness (r_eff, n, d) residues in
    [0, q) or signed values of magnitude at most q/2 (the big-q witness
    convention); r_eff is the witness's own leading dim (r in proving, 1 for
    the verifier's check 15).  With ``rows`` (the range mode): the rows
    row0 .. row0 + rows - 1 of t only, (r_eff, rows, d).  For a
    ``crs.CRSBatch`` of B CRSs: witness (B, r_eff, n, d) -> (B, r_eff,
    kappa or rows, d), instance b committed with ``crs[b]``."""
    if witness.is_cuda:
        return _launch(crs, witness, row0, rows)
    if witness.device.type == "cpu":
        return ajtai_commit_plain(crs, witness, row0, rows)
    raise ValueError(f"no Ajtai kernel for device {witness.device}")


def _row_range(p, row0: int, rows: int | None) -> int:
    """The rows of a call (kappa without a range); raises on a range
    outside A."""
    if rows is None:
        return p.kappa
    if row0 < 0 or rows < 1 or row0 + rows > p.kappa:
        raise ValueError(f"rows {row0} .. {row0 + rows} outside A's "
                         f"{p.kappa}")
    return rows


def ajtai_commit_plain(crs, witness: torch.Tensor, row0: int = 0,
                       rows: int | None = None) -> torch.Tensor:
    p = crs.params
    nd = p.n * p.d
    rows = _row_range(p, row0, rows)
    _check_instances(crs, witness)

    def draw(l0: int, l1: int) -> torch.Tensor:
        return crs._expand_dyn(row0 * nd + l0 * p.d, 0, 0,
                               (rows, l1 - l0, p.d), (nd, p.d, 1),
                               device=witness.device)

    return ring_stream_plain(draw, witness, rows, p.q)


def _check_instances(crs, witness: torch.Tensor) -> None:
    """A batch's witness leads with its instances; a single CRS's has no
    instance axis."""
    B = instances(crs)
    want = 3 if B is None else 4
    if witness.dim() != want or (B is not None and witness.shape[0] != B):
        raise ValueError(f"witness of shape {tuple(witness.shape)} for "
                         + ("one CRS: (r_eff, n, d)" if B is None else
                            f"a batch of {B} CRSs: ({B}, r_eff, n, d)"))


def _launch(crs, witness: torch.Tensor, row0: int,
            rows: int | None) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    table = entry_table(crs, witness.device)
    ranged = rows is not None
    rows = _row_range(p, row0, rows)
    _check_instances(crs, witness)
    batch = instances(crs)
    B = batch or 1
    r_eff = witness.shape[-3]
    cuda_lib.require_cuda_operand(witness, "witness", witness.shape[:-2]
                                  + (p.n, p.d))
    check_big_operand(witness, p.q, "witness")
    if B * r_eff >= 1 << 31 or p.n * p.d >= 1 << 31:
        raise ValueError("Ajtai shape beyond the kernel's int32 indexing")
    out = torch.empty(witness.shape[:-2] + (rows, p.d), dtype=torch.int64,
                      device=witness.device)
    if r_eff == 0:
        return out
    row_tiles, group, l_groups, splits, l_per_split = launch_shape(
        rows, r_eff, p.n, p.q, B)
    if B * -(-r_eff // group) > 65535:
        raise ValueError(f"{B} instances of {r_eff} vectors beyond the "
                         f"kernel's grid")
    part = torch.empty((splits, B, r_eff, rows, p.d), dtype=torch.int64,
                       device=witness.device)
    lib = cuda_lib.load().lib
    stream = cuda_lib.stream_ptr(witness.device)
    if table is not None:
        err = lib.ajtai_commit_table_launch(
            witness.data_ptr(), part.data_ptr(), out.data_ptr(), r_eff, p.n,
            rows, row0, p.q, table.data_ptr(), table.numel(), row_tiles,
            group, l_groups, splits, l_per_split, stream)
        info = KERNEL_TABLE
    else:
        err = lib.ajtai_commit_launch(
            witness.data_ptr(), part.data_ptr(), out.data_ptr(), r_eff, p.n,
            rows, row0, p.q, barrett_m(p.q),
            device_keys(crs, witness.device).data_ptr(), B,
            r_eff * p.n * p.d, row_tiles, group, l_groups, splits,
            l_per_split, stream)
        info = cuda_lib.launch_info(sys.modules[__name__], p.q, ranged,
                                    batch is not None)
    cuda_lib.check(err)
    info.launches += 1
    return out

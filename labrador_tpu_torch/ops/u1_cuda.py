"""The u1 B-term sum_{m, col} B_m[row, col] (*) t_m[col]: the CUDA kernel
(``csrc/u1.cu``), its plain PyTorch version, and the limb scheme of the
kernel.

Replaces ``labrador_tpu/ops/u1_pallas.py`` (``u1_bterm_pallas``), both
its branches: small q, and the 2^32-scale modulus (signed digits, launches
counted in ``KERNEL_BIG``).  The r * t_1 virtual B matrices (kappa_1, kappa, d) sit at
off_b + m * kappa_1 * kappa (no factor d: the reference's stride quirk,
``structs.rs:82``) with row stride kappa * d; m = i * t_1 + k walks the
t digits in the order of the JAX package's stream.

The kernel takes the products on int8 tensor cores: CRS entries as
``entry_limbs(q)`` unsigned 8-bit limbs of the canonical residue, digits
as ``digit_limbs(b_1)`` signed ones (the Pallas kernel's count), int32
sums per limb weight flushed every ``FLUSH_L`` ring elements.  The kernel
checks each digit against what those limbs hold as it loads it and sets a
flag; the wrapper reads the flag after the launch (one device sync) and
raises (``raise_if_flagged``).  The kernel is the stream kernel of
``csrc/mma_stream.cuh``, which the C/D sums (``ops/cd_cuda.py``) share
through their own offset; its limb scheme and launch shape live here.
The range mode (``ncols`` given) sums over the columns col0 .. col0 +
ncols - 1 of every B_m only, one shard of the kappa contraction on a (dp,
rows) mesh, and returns that shard's partial; its launches count in
``KERNEL_RANGE`` / ``KERNEL_RANGE_BIG``.  For a ``crs.MaterializedCRS``
the kernel reads the B entries from its table (the table mode, small q
only, whole and ranged, launches counted in ``KERNEL_TABLE``), with
the same digit check; ``ring_stream.entry_table`` decides.  For a
``crs.CRSBatch`` of B Threefry CRSs the digits lead with B and the batch
mode sums every instance's B-term in one launch (launches in
``KERNEL_BATCH`` / ``KERNEL_BATCH_BIG``, or in the range infos with
``ncols``), with one device sync for every instance's digit flag.
"""

from __future__ import annotations

import sys

import torch

from . import cuda_lib
from .ring_stream import (barrett_m, check_q, device_keys, entry_table,
                          instances, ring_stream_plain)
from .zq import is_big, to_signed_small

KERNEL = cuda_lib.KernelInfo(
    name="u1_bterm",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="u1_bterm_bigq",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:104")
KERNEL_RANGE = cuda_lib.KernelInfo(
    name="u1_bterm_range",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")
KERNEL_RANGE_BIG = cuda_lib.KernelInfo(
    name="u1_bterm_range_bigq",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:104")
KERNEL_TABLE = cuda_lib.KernelInfo(
    name="u1_bterm_table",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")
KERNEL_BATCH = cuda_lib.KernelInfo(
    name="u1_bterm_batch",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")
KERNEL_BATCH_BIG = cuda_lib.KernelInfo(
    name="u1_bterm_batch_bigq",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:104")


def _col_range(p, col0: int, ncols: int | None) -> int:
    """The B columns of a call (kappa without a range); raises on a range
    outside B_m."""
    if ncols is None:
        return p.kappa
    if col0 < 0 or ncols < 1 or col0 + ncols > p.kappa:
        raise ValueError(f"columns {col0} .. {col0 + ncols} outside B's "
                         f"{p.kappa}")
    return ncols


def _stream(t_dig: torch.Tensor, p, col0: int = 0,
            ncols: int | None = None) -> torch.Tensor:
    """(..., t_1, r, kappa, d) digits -> (..., 1, r * t_1 * ncols, d)
    stream in B order (m = i * t_1 + k, then col) over the columns col0
    .. col0 + ncols - 1 (all kappa without a range); a leading instance
    axis stays."""
    ncols = p.kappa if ncols is None else ncols
    block = t_dig[..., col0:col0 + ncols, :]
    return torch.swapaxes(block, -4, -3).reshape(
        t_dig.shape[:-4] + (1, p.r * p.t_1 * ncols, p.d)).contiguous()


def _check_instances(crs, t_dig: torch.Tensor, p) -> None:
    """A batch's digits lead with its instances; a single CRS's have no
    instance axis."""
    B = instances(crs)
    shape = (p.t_1, p.r, p.kappa, p.d)
    want = shape if B is None else (B,) + shape
    if tuple(t_dig.shape) != want:
        raise ValueError(f"t_dig of shape {tuple(t_dig.shape)}, expected "
                         f"{want}")


def u1_bterm(crs, t_dig: torch.Tensor, col0: int = 0,
             ncols: int | None = None) -> torch.Tensor:
    """(kappa_1, d) mod q for t_dig (t_1, r, kappa, d) digits: residues
    mod q, or signed (the big-q convention).  With ``ncols`` (the range
    mode): the partial over the columns col0 .. col0 + ncols - 1 of every
    B_m and of t_dig.  For a ``crs.CRSBatch`` of B CRSs: t_dig (B, t_1,
    r, kappa, d) -> (B, kappa_1, d), instance b summed with ``crs[b]``."""
    if t_dig.is_cuda:
        return _launch(crs, t_dig, col0, ncols)
    if t_dig.device.type == "cpu":
        return u1_bterm_plain(crs, t_dig, col0, ncols)
    raise ValueError(f"no u1 kernel for device {t_dig.device}")


def u1_bterm_plain(crs, t_dig: torch.Tensor, col0: int = 0,
                   ncols: int | None = None) -> torch.Tensor:
    p = crs.params
    kd = p.kappa * p.d
    ncols = _col_range(p, col0, ncols)
    _check_instances(crs, t_dig, p)

    def draw(l0: int, l1: int) -> torch.Tensor:
        # l = m * ncols + lc: offsets off_b + m*k1*k + row*k*d
        # + (col0 + lc)*d + c
        lin = torch.arange(l0, l1, device=t_dig.device)
        col_off = (lin // ncols) * (p.kappa_1 * p.kappa) \
            + (col0 + lin % ncols) * p.d
        row_off = torch.arange(p.kappa_1, device=t_dig.device) * kd
        c = torch.arange(p.d, device=t_dig.device)
        offs = (crs._off_b + row_off[:, None, None] + col_off[None, :, None]
                + c[None, None, :])
        return crs.draw(offs)

    return ring_stream_plain(draw, _stream(t_dig, p, col0, ncols),
                             p.kappa_1, p.q)[..., 0, :, :]


# The stream kernel's limb scheme and launch constants
# (csrc/mma_stream.cuh).
SMALL_ENTRY_LIMBS = 2     # residues below q <= 32513 < 2^15
BIG_ENTRY_LIMBS = 5       # residues below q < 2^33: four bytes, the top bit
MAX_DIGIT_LIMBS = 4
FLUSH_L = 256             # ring elements a warp adds between int32 flushes
_LC = 16                  # ring elements per shared chunk
_MAX_WARPS = 8            # warps per block
_MAX_GROUP_TILES = 4      # row tiles of a block whose warps split l
# warps the launch aims for: 16 on each of the H100's 132 SMs
_TARGET_WARPS = 16 * 132


def entry_limbs(q: int) -> int:
    """Unsigned 8-bit limbs of a CRS entry (a residue in [0, q))."""
    return BIG_ENTRY_LIMBS if is_big(q) else SMALL_ENTRY_LIMBS


def digit_limbs(b: int) -> int:
    """Signed 8-bit limbs that hold any balanced digit of base b (|digit|
    <= b // 2): the count of the Pallas kernel (``ajtai_pallas.digit_limbs``,
    a copy)."""
    n = 1
    while limb_cover(n) < b // 2:
        n += 1
    return n


def limb_cover(n: int) -> int:
    """The largest |x| that n signed 8-bit limbs (each in [-128, 127], the
    split ``x = l_0 + 2^8 l_1 + ...`` with l_k = ((x + 128) & 255) - 128)
    hold for x and for -x alike."""
    return 127 * (256**n - 1) // 255


def check_limb_mode(q: int, n_limbs: int) -> None:
    """Raise if the kernel has no mode with ``n_limbs`` digit limbs at q
    (1-2 at small q, 1-4 at big q).  No device work."""
    if not 1 <= n_limbs <= (MAX_DIGIT_LIMBS if is_big(q) else 2):
        raise ValueError(f"no u1 kernel mode with {n_limbs} digit limbs at "
                         f"q = {q}")


def check_digit_range(t_dig: torch.Tensor, q: int, n_limbs: int,
                      where: str = "") -> None:
    """Raise if a digit, centred as the kernel and the plain version centre
    it (x > q/2 -> x - q), is beyond ``n_limbs`` signed limbs, or if the
    kernel has no mode with that many.  One device sync on the card.
    ``where`` (an instance of a batch) ends the message."""
    check_limb_mode(q, n_limbs)
    if not t_dig.numel():
        return
    top = int(torch.max(torch.abs(to_signed_small(t_dig, q))))
    if top > limb_cover(n_limbs):
        raise ValueError(f"t_dig holds a digit of magnitude {top} beyond "
                         f"the {n_limbs} limbs of the u1 kernel "
                         f"(|digit| <= {limb_cover(n_limbs)}){where}")


def raise_if_flagged(bad: torch.Tensor, digits: torch.Tensor, q: int,
                     n_limbs: int, batched: bool = False) -> None:
    """After a launch: raise if the kernel flagged a digit beyond its limbs
    (``bad`` nonzero; reading it is the one device sync), with
    ``check_digit_range``'s message.  ``batched``: ``bad`` holds one flag
    an instance and ``digits`` leads with the instances; the message names
    the first flagged instance."""
    flags = bad.tolist()
    if not any(flags):
        return
    b = next(i for i, f in enumerate(flags) if f)
    where = f" in instance {b}" if batched else ""
    check_digit_range(digits[b] if batched else digits, q, n_limbs, where)
    raise ValueError(f"the stream kernel flagged a digit beyond its "
                     f"{n_limbs} limbs{where}")


def launch_shape(rows: int, L: int,
                 instances: int = 1) -> tuple[int, int, int, int]:
    """(tiles, groups, splits, ring elements per split) of a stream-kernel
    launch: blocks of up to 8 warps, ``tiles`` 8-row tiles times ``groups``
    warps that split each chunk's ring elements, a batch's ``instances``
    over grid.z first, then the l stream split over grid.x until the grid
    holds at most _TARGET_WARPS warps (a grid one block-row beyond the
    card's resident blocks runs a second wave).  The most tiles
    per block that still come near that target (a block's digit loads and
    circulant serve all its rows): kappa = 256 with a long stream, 8 tiles
    x 64 splits; kappa' = 16, 2 tiles x 4 groups, about 260 splits of
    hundreds of ring elements at L ~ 10^5; a short stream (the 2^14
    C-term, L = 136), 1 tile x 8 groups over 32 row blocks."""
    tiles = min(_MAX_WARPS, -(-rows // 8))
    while True:
        groups = _MAX_WARPS // tiles if tiles <= _MAX_GROUP_TILES else 1
        row_blocks = -(-rows // (8 * tiles)) * instances
        # at most the target: one block-row beyond it is a second wave
        want = max(1, _TARGET_WARPS // (row_blocks * tiles * groups))
        per = -(-L // max(1, min(want, -(-L // _LC))))
        l_per_split = -(-per // _LC) * _LC
        splits = -(-L // l_per_split)
        # three quarters of the target, so that the rounding of a split to
        # whole chunks does not cost a long stream its row tiles
        if tiles == 1 or 4 * splits * row_blocks * tiles * groups \
                >= 3 * _TARGET_WARPS:
            return tiles, groups, splits, l_per_split
        tiles = 1 << (min(tiles - 1, _MAX_GROUP_TILES).bit_length() - 1)


def _launch(crs, t_dig: torch.Tensor, col0: int,
            ncols: int | None) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    table = entry_table(crs, t_dig.device)
    ranged = ncols is not None
    ncols = _col_range(p, col0, ncols)
    _check_instances(crs, t_dig, p)
    cuda_lib.require_cuda_operand(t_dig, "t_dig", t_dig.shape)
    batch = instances(crs)
    B = batch or 1
    n_limbs = digit_limbs(p.b_1)
    check_limb_mode(p.q, n_limbs)
    m_total = p.r * p.t_1
    L = m_total * ncols
    if m_total * p.kappa >= 1 << 31 or p.kappa_1 * p.d >= 1 << 31 \
            or B > 65535:
        raise ValueError("u1 shape beyond the kernel's int32 indexing")
    stream = _stream(t_dig, p, col0, ncols)
    tiles, groups, splits, l_per_split = launch_shape(p.kappa_1, L, B)
    part = torch.empty((splits, B, p.kappa_1, p.d), dtype=torch.int64,
                       device=t_dig.device)
    out = torch.empty(t_dig.shape[:-4] + (p.kappa_1, p.d),
                      dtype=torch.int64, device=t_dig.device)
    bad = torch.empty((B,), dtype=torch.int32, device=t_dig.device)
    lib = cuda_lib.load().lib
    cuda_stream = cuda_lib.stream_ptr(t_dig.device)
    if table is not None:
        err = lib.u1_bterm_table_launch(
            stream.data_ptr(), part.data_ptr(), out.data_ptr(),
            bad.data_ptr(), m_total, ncols, p.kappa, p.kappa_1, col0, p.q,
            crs._off_b, table.data_ptr(), table.numel(), n_limbs, tiles,
            groups, splits, l_per_split, cuda_stream)
        info = KERNEL_TABLE
    else:
        err = lib.u1_bterm_launch(
            stream.data_ptr(), part.data_ptr(), out.data_ptr(),
            bad.data_ptr(), m_total, ncols, p.kappa, p.kappa_1, col0, p.q,
            barrett_m(p.q), crs._off_b,
            device_keys(crs, t_dig.device).data_ptr(), B, L * p.d, n_limbs,
            tiles, groups, splits, l_per_split, cuda_stream)
        info = cuda_lib.launch_info(sys.modules[__name__], p.q, ranged,
                                    batch is not None)
    cuda_lib.check(err)
    info.launches += 1
    raise_if_flagged(bad, stream, p.q, n_limbs, batch is not None)
    return out

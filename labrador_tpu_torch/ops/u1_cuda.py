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
sums per limb weight flushed every ``FLUSH_L`` ring elements.  The wrapper
checks the digits against what those limbs hold (``check_digit_range``)
and raises outside it.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .ring_stream import barrett_m, check_q, ring_stream_plain
from .zq import is_big, to_signed_small

KERNEL = cuda_lib.KernelInfo(
    name="u1_bterm",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:164")
KERNEL_BIG = cuda_lib.KernelInfo(
    name="u1_bterm_bigq",
    source="labrador_tpu_torch/csrc/u1.cu",
    replaces="labrador_tpu/ops/u1_pallas.py:104")


def _stream(t_dig: torch.Tensor, p) -> torch.Tensor:
    """(t_1, r, kappa, d) digits -> (1, r * t_1 * kappa, d) stream in B
    order (m = i * t_1 + k, then col)."""
    return torch.swapaxes(t_dig, 0, 1).reshape(1, p.r * p.t_1 * p.kappa,
                                                p.d).contiguous()


def u1_bterm(crs, t_dig: torch.Tensor) -> torch.Tensor:
    """(kappa_1, d) mod q for t_dig (t_1, r, kappa, d) digits: residues
    mod q, or signed (the big-q convention)."""
    if t_dig.is_cuda:
        return _launch(crs, t_dig)
    if t_dig.device.type == "cpu":
        return u1_bterm_plain(crs, t_dig)
    raise ValueError(f"no u1 kernel for device {t_dig.device}")


def u1_bterm_plain(crs, t_dig: torch.Tensor) -> torch.Tensor:
    p = crs.params
    kd = p.kappa * p.d

    def draw(l0: int, l1: int) -> torch.Tensor:
        # l = m * kappa + col: offsets off_b + m*k1*k + row*k*d + col*d + c
        lin = torch.arange(l0, l1, device=t_dig.device)
        col_off = (lin // p.kappa) * (p.kappa_1 * p.kappa) \
            + (lin % p.kappa) * p.d
        row_off = torch.arange(p.kappa_1, device=t_dig.device) * kd
        c = torch.arange(p.d, device=t_dig.device)
        offs = (crs._off_b + row_off[:, None, None] + col_off[None, :, None]
                + c[None, None, :])
        return crs.draw(offs)

    return ring_stream_plain(draw, _stream(t_dig, p), p.kappa_1, p.q)[0]


# The kernel's limb scheme and launch constants (csrc/u1.cu).
SMALL_ENTRY_LIMBS = 2     # residues below q <= 32513 < 2^15
BIG_ENTRY_LIMBS = 5       # residues below q < 2^33: four bytes, the top bit
MAX_DIGIT_LIMBS = 4
FLUSH_L = 256             # ring elements between the int32 flushes
_LC = 16                  # ring elements per shared chunk
_MAX_WARPS = 8            # 8-row tiles per block
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


def check_digit_range(t_dig: torch.Tensor, q: int, n_limbs: int) -> None:
    """Raise if a digit, centred as the kernel and the plain version centre
    it (x > q/2 -> x - q), is beyond ``n_limbs`` signed limbs, or if the
    kernel has no mode with that many.  One device sync on the card."""
    if not 1 <= n_limbs <= (MAX_DIGIT_LIMBS if is_big(q) else 2):
        raise ValueError(f"no u1 kernel mode with {n_limbs} digit limbs at "
                         f"q = {q}")
    if not t_dig.numel():
        return
    top = int(torch.max(torch.abs(to_signed_small(t_dig, q))))
    if top > limb_cover(n_limbs):
        raise ValueError(f"t_dig holds a digit of magnitude {top} beyond "
                         f"the {n_limbs} limbs of the u1 kernel "
                         f"(|digit| <= {limb_cover(n_limbs)})")


def launch_shape(rows: int, L: int) -> tuple[int, int, int]:
    """(warps per block, splits, ring elements per split) of the u1 launch:
    blocks of up to 8 warps, one 8-row tile each, so that a block shares
    its circulant among its warps; the l stream split over grid.x until the
    grid holds about _TARGET_WARPS warps (kappa_1 = 256: 4 row blocks x 64
    splits; the folded kappa_1 = 16: blocks of 2 warps, ~1000 splits)."""
    warps = min(_MAX_WARPS, -(-rows // 8))
    row_blocks = -(-rows // (8 * warps))
    want = -(-_TARGET_WARPS // (row_blocks * warps))
    splits = max(1, min(want, -(-L // _LC)))
    per = -(-L // splits)
    l_per_split = -(-per // _LC) * _LC
    return warps, -(-L // l_per_split), l_per_split


def _launch(crs, t_dig: torch.Tensor) -> torch.Tensor:
    p = crs.params
    check_q(p.q, p.d)
    cuda_lib.require_cuda_operand(t_dig, "t_dig", (p.t_1, p.r, p.kappa, p.d))
    n_limbs = digit_limbs(p.b_1)
    check_digit_range(t_dig, p.q, n_limbs)
    m_total = p.r * p.t_1
    L = m_total * p.kappa
    if L >= 1 << 31 or p.kappa_1 * p.d >= 1 << 31:
        raise ValueError("u1 shape beyond the kernel's int32 indexing")
    stream = _stream(t_dig, p)
    warps, splits, l_per_split = launch_shape(p.kappa_1, L)
    part = torch.empty((splits, 1, p.kappa_1, p.d), dtype=torch.int64,
                       device=t_dig.device)
    out = torch.empty((p.kappa_1, p.d), dtype=torch.int64,
                      device=t_dig.device)
    lib = cuda_lib.load().lib
    err = lib.u1_bterm_launch(
        stream.data_ptr(), part.data_ptr(), out.data_ptr(), m_total, p.kappa,
        p.kappa_1, p.q, barrett_m(p.q), crs._off_b, crs.key[0], crs.key[1],
        n_limbs, warps, splits, l_per_split,
        cuda_lib.stream_ptr(t_dig.device))
    cuda_lib.check(err)
    (KERNEL_BIG if is_big(p.q) else KERNEL).launches += 1
    return out

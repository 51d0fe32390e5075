"""Peaks of the card and the least time of a commitment stream call.

The least time of a call is the larger of two numbers, each counted from
what the protocol requires of the call, not from how a kernel does it:

* its bytes, each input read once and each output written once (the
  int64 digit stream in, the int64 (rows, d) result out), over the memory
  rate;
* the CRS entries that the protocol's Threefry derivation requires
  (rows x stream length x d, one Threefry-2x32 block an entry), times
  THREEFRY_OPS int32 operations an entry, over the int32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# Not a data-sheet figure: derived as 132 SMs x 64 INT32 lanes an SM x the
# 1.98 GHz boost clock (NVIDIA's H100 whitepaper), one int32 operation a
# lane a clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one Threefry-2x32 block: 20 rounds of add, rotate
# and xor, and 5 key injections of 3 adds.
THREEFRY_OPS = 20 * 3 + 5 * 3


def stream_least_s(rows: int, length: int, d: int,
                   instances: int = 1) -> float:
    """Least seconds of one stream contraction out (rows, d) = sum over
    ``length`` ring elements of CRS entry (*) digit."""
    nbytes = 8 * d * (length + rows) * instances
    entries = rows * length * d * instances
    return max(nbytes / HBM_BYTES_PER_S,
               entries * THREEFRY_OPS / INT32_OPS_PER_S)


def stream_kernel_s(trace, offset: str) -> float:
    """Summed device seconds of the stream kernel (``mma_stream_kernel``)
    instantiated with the offset functor ``offset``, each with the split
    reduction (``reduce_splits_kernel``) that its launch queues after it
    on the same stream."""
    total, owner = 0.0, None
    for name, s, e in sorted(trace.device, key=lambda x: x[1]):
        if "mma_stream_kernel" in name:
            owner = offset in name
            total += (e - s) if owner else 0.0
        elif "reduce_splits_kernel" in name:
            total += (e - s) if owner else 0.0
            owner = None
    return total


def share(rec, span: str, offset: str) -> float | None:
    """100 x the summed least time of the probed calls ``span`` made while
    the profiler was on, over the kernel's summed device time; None where
    the trace holds none of either."""
    if rec.trace is None:
        return None
    device_s = stream_kernel_s(rec.trace, offset)
    least = sum(stream_least_s(**c) for on, c in rec.calls.get(span, [])
                if on)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s

// Shared device code of the commitment kernels (ajtai.cu, and u1.cu and
// cd.cu through mma_stream.cuh): the Threefry block that expands the
// virtual CRS in-kernel, the Barrett reduction of its 64-bit word, the
// 128-bit reduction of the big-q flush (mod_i128) and the second pass that
// sums the partials of the splits of a stream (reduce_splits_kernel).
//
// All three commitments of the interactive path have one shape:
//
//     out[j][row][k] = ( sum_{l < L}  M(l, row) (*) dig[j][l] )[k]  mod q
//
// where (*) is the negacyclic product in Zq[X]/(X^64 + 1), M(l, row) is a
// ring element of the virtual CRS (64 consecutive Threefry-2x32 counters
// from a 64-bit offset that each kernel computes), and dig[j][l] is a
// small witness or digit polynomial.  The Pallas kernels compute the same
// sums as int8 MXU matmuls against a circulant, per CRT prime, with a
// Garner epilogue; here the products run on int8 tensor cores in 8-bit
// limbs of the residue itself, with no CRT (mma_stream.cuh, ajtai.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;                  // ring degree

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One 20-round Threefry-2x32 block (labrador_tpu/ops/prg.py threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define LAB_ROUND(r) x0 += x1; x1 = rotl32(x1, r) ^ x0;
  LAB_ROUND(13) LAB_ROUND(15) LAB_ROUND(26) LAB_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  LAB_ROUND(17) LAB_ROUND(29) LAB_ROUND(16) LAB_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  LAB_ROUND(13) LAB_ROUND(15) LAB_ROUND(26) LAB_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  LAB_ROUND(17) LAB_ROUND(29) LAB_ROUND(16) LAB_ROUND(24)
  x0 += k1; x1 += ks2 + 4u;
  LAB_ROUND(13) LAB_ROUND(15) LAB_ROUND(26) LAB_ROUND(6)
  x0 += ks2; x1 += k0 + 5u;
#undef LAB_ROUND
  o0 = x0;
  o1 = x1;
}

// Largest small-q modulus (ops/modmath.py P_MAX); the wrappers admit only
// q <= SMALL_Q_MAX or 2^32 < q < 2^33.
constexpr int64_t SMALL_Q_MAX = 32513;

// x mod q for any 64-bit word x, by Barrett reduction with the constant
// m = floor((2^64 - 1) / q) (ring_stream.barrett_m, computed on the host):
// with rho = (2^64 - 1) mod q < q, x m / 2^64 = x / q - x (1 + rho) /
// (q 2^64), and x < 2^64, 1 + rho <= q make the second term < 1, so
// t = floor(x m / 2^64) is floor(x / q) or one less.  r = x - t q is then
// in [0, 2q) (exact in wrapping 64-bit arithmetic, as 2q < 2^34), and one
// conditional subtraction gives the residue.  It replaces a generic
// 64-bit `%` with a runtime q, which the card runs as a software division.
__device__ __forceinline__ uint64_t barrett_mod(uint64_t x, uint64_t q,
                                                uint64_t m) {
  const uint64_t r = x - __umul64hi(x, m) * q;
  return r >= q ? r - q : r;
}

// CRS entry at a 64-bit offset: the Threefry output (x0 * 2^32 + x1) mod q
// in [0, q), which is what prg.uniform_mod_q computes at any q.
__device__ __forceinline__ int64_t crs_coeff(uint32_t k0, uint32_t k1,
                                             uint64_t off, uint64_t q,
                                             uint64_t barrett_m) {
  uint32_t x0, x1;
  threefry2x32(k0, k1, static_cast<uint32_t>(off >> 32),
               static_cast<uint32_t>(off), x0, x1);
  return static_cast<int64_t>(barrett_mod(
      (static_cast<uint64_t>(x0) << 32) | x1, q, barrett_m));
}

// v mod q in [0, q) for |v| < 2^73 (|v >> 64| <= 2^9): v = hi 2^64 + lo is
// congruent to hi * c64 + lo with c64 = 2^64 mod q < 2^33, so every term
// stays below 2^43 in int64.
__device__ __forceinline__ int64_t mod_i128(__int128 v, int64_t q,
                                            int64_t c64) {
  const int64_t hi = static_cast<int64_t>(v >> 64);
  const uint64_t lo = static_cast<uint64_t>(v);
  const int64_t t = (hi * c64 + static_cast<int64_t>(
      lo % static_cast<uint64_t>(q))) % q;
  return t < 0 ? t + q : t;
}

// out[i] = sum_s part[s][i] mod q over n outputs (part entries in [0, q)):
// at most 65535 splits of terms below q < 2^33 sum below 2^49 in int64.
__global__ void reduce_splits_kernel(const int64_t* __restrict__ part,
                                     int64_t* __restrict__ out, int splits,
                                     int64_t n, int64_t q) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= n) return;
  int64_t t = 0;
  for (int s = 0; s < splits; ++s) t += part[s * n + idx];
  out[idx] = t % q;
}

}  // namespace

// Shared device code of the commitment kernels: the ring-stream kernel of
// ajtai.cu, and the Threefry block, the Barrett reduction of its word,
// mod_i128 and the split reduction that the tensor-core stream kernel of
// u1.cu and cd.cu (mma_stream.cuh) uses as well.
//
// All three commitments of the interactive path have one shape:
//
//     out[j][row][k] = ( sum_{l < L}  M(l, row) (*) dig[j][l] )[k]  mod q
//
// where (*) is the negacyclic product in Zq[X]/(X^64 + 1), M(l, row) is a
// ring element of the virtual CRS (64 consecutive Threefry-2x32 counters
// from a 64-bit offset that each kernel's offset functor computes), and
// dig[j][l] is a small witness or digit polynomial.  The Pallas kernels
// compute the same sums as int8 MXU matmuls against a circulant, per CRT
// prime, with a Garner epilogue; here one wide accumulator per output
// coefficient is exact and needs no CRT at all:
//   * small q (SMALL): |M| < q <= 32513 < 2^15 and |centred dig| <= q/2 <
//     2^14, so each product fits int32 (< 2^29) and an int64 sum of up to
//     2^34 of them is exact;
//   * big q, 2^32 < q < 2^33 (the 2^32-scale modulus is 4294967311): entry
//     and operand are both centred, |M|, |dig| <= q/2 (the wrapper asserts
//     the operand range), so every operand of the JAX convention is
//     admitted: a signed witness up to 2^31 in magnitude, signed digits,
//     canonical residues.  Below BIG_NARROW_Q_END = 2^32 + 2^30 (BIG) q/2 <
//     1.25 * 2^31 and a product is below 1.5625 * 2^62, an int64 multiply;
//     above it (BIG_WIDE) a product reaches 2^64 and is taken as __int128
//     (mul_wide), about twice the work per product, so the kernel keeps the
//     int64 product where it fits.  Products are summed in __int128 and
//     reduced mod q after every chunk of at most LC * D = 512 products per
//     thread, so the accumulator stays below 2^73 and its reduction
//     (mod_i128) below 2^43.
//
// Design of the ring-stream kernel (simple and right first; mma_stream.cuh
// has the tensor-core limb products that u1 and C/D take through their
// offset functors, and Ajtai can adopt):
//   * grid (rows, splits, rhs groups), 256 threads = 4 groups x 64 output
//     coefficients; a block walks its share of l in chunks of LC ring
//     elements;
//   * per chunk the block generates each CRS entry it needs exactly once,
//     in registers, into shared memory (the CRS never touches global
//     memory, as on the TPU), and stages the centred digits doubled with
//     the negacyclic sign, ext[m] = m >= 64 ? v[m-64] : -v[m], so the
//     product needs no branch: (M (*) v)[k] = sum_i M[i] * ext[k - i + 64];
//   * with one right-hand side the 4 groups split the chunk's ring elements
//     and are summed in shared memory at the end; with several (the Ajtai
//     witness vectors) group g takes right-hand side 4 * blockIdx.z + g;
//   * each block writes its partial mod q; a second kernel sums the splits
//     mod q (blocks run in no order, so nothing carries between them).
// What bounds it on the H100: integer issue rate — one Threefry block and a
// Barrett reduction per CRS entry, and an int32 multiply + int64 add per
// product at small q (a 64-bit or 128-bit product + 128-bit add at big
// q); global
// traffic is only the digits and the output.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;                  // ring degree
constexpr int THREADS = 256;           // 4 groups of D threads
constexpr int GROUPS = THREADS / D;
constexpr int LC = 8;                  // ring elements per shared chunk

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
// Big-q moduli below this take int64 products (bounds at the top).
constexpr int64_t BIG_NARROW_Q_END = (int64_t{1} << 32) + (int64_t{1} << 30);

// The kernel's modes, chosen by q at launch (bounds at the top).
enum RingMode { SMALL, BIG, BIG_WIDE };

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

// Operand and accumulator types of the modes (bounds at the top).
template <int MODE> struct RingTypes {
  using Entry = int64_t;    // centred M and dig, both <= q/2 < 2^32
  using Acc = __int128;
};
template <> struct RingTypes<SMALL> {
  using Entry = int32_t;    // M in [0, q), centred dig: below 2^15
  using Acc = int64_t;
};

// The full product of two values below 2^32 in magnitude (BIG_WIDE): low
// word by a 64-bit multiply, high word by __mul64hi.
__device__ __forceinline__ __int128 mul_wide(int64_t a, int64_t b) {
  const uint64_t lo = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  const int64_t hi = __mul64hi(a, b);
  return static_cast<__int128>(
      (static_cast<unsigned __int128>(static_cast<uint64_t>(hi)) << 64) | lo);
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

__device__ __forceinline__ int64_t acc_mod(int64_t v, int64_t q, int64_t) {
  const int64_t t = v % q;
  return t < 0 ? t + q : t;
}

__device__ __forceinline__ int64_t acc_mod(__int128 v, int64_t q,
                                           int64_t c64) {
  return mod_i128(v, q, c64);
}

// part[s][j][row][k] = (sum over split s of M(l, row) (*) dig[j][l])[k] mod q.
// dig: (nrhs, L, D) residues in [0, q) or signed values of magnitude at
// most q/2 (both centred alike); part: (splits, nrhs, rows, D).
template <class Off, int MODE>
__global__ void __launch_bounds__(THREADS)
ring_stream_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
                   int nrhs, int L, int rows, int64_t q, uint64_t barrett_m,
                   uint32_t k0, uint32_t k1, Off off, int l_per_split) {
  constexpr bool BIG_Q = MODE != SMALL;
  using Entry = typename RingTypes<MODE>::Entry;
  using Acc = typename RingTypes<MODE>::Acc;
  __shared__ Entry m_sh[LC][D];
  __shared__ Entry ext[GROUPS][LC][2 * D];
  __shared__ int64_t red[GROUPS][D];
  const int row = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = tid / D;
  const int k = tid % D;
  const bool split_l = (nrhs == 1);
  const int j = split_l ? 0 : blockIdx.z * GROUPS + g;
  const int n_ext = split_l ? 1 : GROUPS;
  const int eg = split_l ? 0 : g;
  const int l_first = split_l ? g : 0;
  const int l_step = split_l ? GROUPS : 1;
  const int l_begin = s * l_per_split;
  const int l_end = min(L, l_begin + l_per_split);
  const int64_t half_q = q / 2;
  // 2^64 mod q (only the big mode reads it)
  const int64_t c64 = static_cast<int64_t>(
      (0 - static_cast<uint64_t>(q)) % static_cast<uint64_t>(q));

  Acc acc = 0;
  for (int l0 = l_begin; l0 < l_end; l0 += LC) {
    const int nl = min(LC, l_end - l0);
    for (int e = tid; e < LC * D; e += THREADS) {
      const int l = e / D, c = e % D;
      Entry m = 0;
      if (l < nl) {
        const int64_t x = crs_coeff(
            k0, k1, off(l0 + l, row) + static_cast<uint64_t>(c),
            static_cast<uint64_t>(q), barrett_m);
        m = static_cast<Entry>(BIG_Q && x > half_q ? x - q : x);
      }
      m_sh[l][c] = m;
    }
    for (int e = tid; e < n_ext * LC * D; e += THREADS) {
      const int gg = e / (LC * D), l = (e / D) % LC, c = e % D;
      const int jj = split_l ? 0 : blockIdx.z * GROUPS + gg;
      Entry v = 0;
      if (l < nl && jj < nrhs) {
        const int64_t x = dig[(static_cast<int64_t>(jj) * L + l0 + l) * D + c];
        v = static_cast<Entry>(x > half_q ? x - q : x);
      }
      ext[gg][l][c + D] = v;
      ext[gg][l][c] = -v;
    }
    __syncthreads();
    for (int l = l_first; l < nl; l += l_step) {
      const Entry* e = &ext[eg][l][k + D];         // e[-i] = ext[k - i + D]
#pragma unroll 16
      for (int i = 0; i < D; ++i) {
        if constexpr (MODE == BIG_WIDE) {
          acc += mul_wide(m_sh[l][i], e[-i]);
        } else {  // int32 (SMALL) or int64 (BIG) product, bounds at the top
          acc += static_cast<Acc>(m_sh[l][i] * e[-i]);
        }
      }
    }
    if (BIG_Q) acc = acc_mod(acc, q, c64);  // <= 512 products since the last
    __syncthreads();
  }

  // each thread's sum as a residue in [0, q); four of them sum below 2^35
  const int64_t res = acc_mod(acc, q, c64);
  const int64_t base = (static_cast<int64_t>(s) * nrhs + j) * rows + row;
  if (split_l) {
    red[g][k] = res;
    __syncthreads();
    if (g == 0) {
      part[base * D + k] = (red[0][k] + red[1][k] + red[2][k] + red[3][k]) % q;
    }
  } else if (j < nrhs) {
    part[base * D + k] = res;
  }
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

// Launch both kernels on `stream`; returns the first launch error.
template <class Off>
cudaError_t launch_ring_stream(const int64_t* dig, int64_t* part,
                               int64_t* out, int nrhs, int L, int rows,
                               int64_t q, uint64_t barrett_m, uint32_t k0,
                               uint32_t k1, Off off, int splits,
                               cudaStream_t stream) {
  const int zb = nrhs == 1 ? 1 : (nrhs + GROUPS - 1) / GROUPS;
  const int per = (L + splits - 1) / splits;
  const int l_per_split = (per + LC - 1) / LC * LC;
  const dim3 grid(rows, splits, zb);
  if (q <= SMALL_Q_MAX) {
    ring_stream_kernel<Off, SMALL><<<grid, THREADS, 0, stream>>>(
        dig, part, nrhs, L, rows, q, barrett_m, k0, k1, off, l_per_split);
  } else if (q < BIG_NARROW_Q_END) {
    ring_stream_kernel<Off, BIG><<<grid, THREADS, 0, stream>>>(
        dig, part, nrhs, L, rows, q, barrett_m, k0, k1, off, l_per_split);
  } else {
    ring_stream_kernel<Off, BIG_WIDE><<<grid, THREADS, 0, stream>>>(
        dig, part, nrhs, L, rows, q, barrett_m, k0, k1, off, l_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(nrhs) * rows * D;
  const int64_t blocks = (n + 255) / 256;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, out, splits, n, q);
  return cudaGetLastError();
}

}  // namespace

// Shared device code of the commitment kernels (ajtai.cu, u1.cu, cd.cu).
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
// prime, with a Garner epilogue; here, at small q, one int64 accumulator
// per output coefficient is exact and needs no CRT at all:
//   |M| < q <= 32513 < 2^15 and |centred dig| <= q/2 < 2^14, so each product
//   fits int32 (< 2^29) and an int64 sum of up to 2^34 of them is exact.
//
// Design (simple and right first; tensor-core limb products, TMA and
// tiling for speed are later work):
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
// 64-bit modulo per CRS entry, and an int32 multiply + int64 add per
// product; global traffic is only the digits and the output.
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

// CRS entry at a 64-bit offset: the Threefry output (x0 * 2^32 + x1) mod q,
// which is what prg.uniform_mod_q computes at small q.
__device__ __forceinline__ int32_t crs_coeff(uint32_t k0, uint32_t k1,
                                             uint64_t off, uint64_t q) {
  uint32_t x0, x1;
  threefry2x32(k0, k1, static_cast<uint32_t>(off >> 32),
               static_cast<uint32_t>(off), x0, x1);
  return static_cast<int32_t>(((static_cast<uint64_t>(x0) << 32) | x1) % q);
}

// part[s][j][row][k] = (sum over split s of M(l, row) (*) dig[j][l])[k] mod q.
// dig: (nrhs, L, D) residues in [0, q); part: (splits, nrhs, rows, D).
template <class Off>
__global__ void __launch_bounds__(THREADS)
ring_stream_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
                   int nrhs, int L, int rows, int64_t q, uint32_t k0,
                   uint32_t k1, Off off, int l_per_split) {
  __shared__ int32_t m_sh[LC][D];
  __shared__ int32_t ext[GROUPS][LC][2 * D];
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

  int64_t acc = 0;
  for (int l0 = l_begin; l0 < l_end; l0 += LC) {
    const int nl = min(LC, l_end - l0);
    for (int e = tid; e < LC * D; e += THREADS) {
      const int l = e / D, c = e % D;
      m_sh[l][c] = (l < nl)
          ? crs_coeff(k0, k1, off(l0 + l, row) + static_cast<uint64_t>(c),
                      static_cast<uint64_t>(q))
          : 0;
    }
    for (int e = tid; e < n_ext * LC * D; e += THREADS) {
      const int gg = e / (LC * D), l = (e / D) % LC, c = e % D;
      const int jj = split_l ? 0 : blockIdx.z * GROUPS + gg;
      int32_t v = 0;
      if (l < nl && jj < nrhs) {
        const int64_t x = dig[(static_cast<int64_t>(jj) * L + l0 + l) * D + c];
        v = static_cast<int32_t>(x > half_q ? x - q : x);
      }
      ext[gg][l][c + D] = v;
      ext[gg][l][c] = -v;
    }
    __syncthreads();
    for (int l = l_first; l < nl; l += l_step) {
      const int32_t* e = &ext[eg][l][k + D];       // e[-i] = ext[k - i + D]
#pragma unroll 16
      for (int i = 0; i < D; ++i) {
        acc += static_cast<int64_t>(m_sh[l][i] * e[-i]);
      }
    }
    __syncthreads();
  }

  const int64_t base = (static_cast<int64_t>(s) * nrhs + j) * rows + row;
  if (split_l) {
    red[g][k] = acc;
    __syncthreads();
    if (g == 0) {
      int64_t t = (red[0][k] + red[1][k] + red[2][k] + red[3][k]) % q;
      part[base * D + k] = t < 0 ? t + q : t;
    }
  } else if (j < nrhs) {
    const int64_t t = acc % q;
    part[base * D + k] = t < 0 ? t + q : t;
  }
}

// out[i] = sum_s part[s][i] mod q over n outputs (part entries in [0, q)).
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
                               int64_t q, uint32_t k0, uint32_t k1, Off off,
                               int splits, cudaStream_t stream) {
  const int zb = nrhs == 1 ? 1 : (nrhs + GROUPS - 1) / GROUPS;
  const int per = (L + splits - 1) / splits;
  const int l_per_split = (per + LC - 1) / LC * LC;
  const dim3 grid(rows, splits, zb);
  ring_stream_kernel<Off><<<grid, THREADS, 0, stream>>>(
      dig, part, nrhs, L, rows, q, k0, k1, off, l_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(nrhs) * rows * D;
  const int64_t blocks = (n + 255) / 256;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, out, splits, n, q);
  return cudaGetLastError();
}

}  // namespace

// Fused batched negacyclic product in Rq = Zq[X]/(X^64 + 1), q <= 32513.
//
// Replaces labrador_tpu/ops/ntt_pallas.py: _build_call (the pallas_call at
// line 270) with its entry points negacyclic_polymul_pallas (line 300) and
// negacyclic_polymul_pallas_bhat (line 321).  Of the TPU kernel only the
// math is kept; the paired-lane layout, the int8 limb packing and the
// float32 Barrett steps exist for the TPU's int8 MXU and have no purpose
// here.  Two variants, both writing residues in [0, q):
//
// polymul_coef   out[n] = a[n] (*) b[n] mod q, both in the coefficient
//   domain.  An exact int64 schoolbook: the operands are reduced to
//   [0, q) first, each product a_i * b_j < q^2 < 2^30 fits int32, and a
//   64-term sum |sum| < 64 q^2 < 2^36 is exact in int64; one modulo at the
//   end.  This is the same residue as the CRT route (transform per prime,
//   pointwise product, inverse, Garner), which is exact for |a|, |b| < q,
//   at about a twelfth of its multiply-adds.  The negacyclic sign is folded
//   into a doubled copy of b in shared memory, ext[m] = m >= 64 ? b[m-64]
//   : -b[m], so (a (*) b)[k] = sum_i a[i] * ext[k - i + 64], branch-free.
//
// polymul_bhat   out[n] = INTT(NTT(a[n]) .* bhat[:, n]) folded mod q, the
//   second operand given in the evaluation domain, per CRT prime (the
//   serving shape of one operand fixed across many products).  It must go
//   through the CRT: per prime p, the forward transform x = (a mod p) @ V_p
//   mod p, the pointwise product with bhat mod p, the inverse transform
//   @ W_p mod p; then Garner's mixed-radix digits and the signed fold mod q
//   exactly as ops/zq.fold_res_modq computes them (digit chain, comparison
//   with floor(M/2), final mod q).  Each 64-term transform sum is below
//   64 p^2 < 2^37 and accumulates in int64.  The plan's V and W tables
//   (P x 64 x 64 int32 each, 32 KB per prime) and the Garner constants are
//   loaded into shared memory once per block, and blocks are persistent
//   (one per SM) so that load is paid once per SM.
//
// Shapes (checked by ops/polymul_cuda.py): rows of 64 int64 coefficients,
// n rows; an operand that broadcasts one row over all n has row stride 0,
// else 64.  bhat is (P, n or 1, 64), P <= MAX_P.
// Bounds on the H100: at the main path's shapes the coefficient variant is
// bound by the bytes it moves (int64 in and out: 3 x 512 B per product)
// against 4,096 int32 multiply-adds; the bhat variant does 2 x 4,096
// multiply-adds per prime per product and is bound by integer issue.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;
constexpr int MAX_P = 6;                         // CRT primes the kernel holds
constexpr int COEF_ROWS = 4;                     // products per block step
constexpr int COEF_THREADS = COEF_ROWS * D;
constexpr int BHAT_ROWS = 8;
constexpr int BHAT_THREADS = BHAT_ROWS * D;
constexpr int N_CONSTS = 3 * MAX_P + MAX_P * MAX_P + 1;

__device__ __forceinline__ int64_t mod_pos(int64_t x, int64_t m) {
  const int64_t t = x % m;
  return t < 0 ? t + m : t;
}

__global__ void __launch_bounds__(COEF_THREADS)
polymul_coef_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ b, int64_t* __restrict__ out,
                    int64_t n, int64_t a_stride, int64_t b_stride,
                    int64_t q) {
  __shared__ int32_t a_sh[COEF_ROWS][D];
  __shared__ int32_t ext[COEF_ROWS][2 * D];
  const int r = threadIdx.x / D;
  const int k = threadIdx.x % D;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * COEF_ROWS; row0 < n;
       row0 += static_cast<int64_t>(gridDim.x) * COEF_ROWS) {
    const int64_t row = row0 + r;
    int32_t av = 0, bv = 0;
    if (row < n) {
      av = static_cast<int32_t>(mod_pos(a[row * a_stride + k], q));
      bv = static_cast<int32_t>(mod_pos(b[row * b_stride + k], q));
    }
    a_sh[r][k] = av;
    ext[r][k + D] = bv;
    ext[r][k] = -bv;
    __syncthreads();
    const int32_t* e = &ext[r][k + D];              // e[-i] = ext[k - i + D]
    int64_t acc = 0;
#pragma unroll 16
    for (int i = 0; i < D; ++i) acc += a_sh[r][i] * e[-i];   // < 2^30 each
    if (row < n) out[row * D + k] = mod_pos(acc, q);
    __syncthreads();
  }
}

// consts: primes[P] | garner_inv[P][P] (inv(p_j) mod p_k at [j][k]) |
//         m_half_digits[P] | prefix_mod_q[P] | m_mod_q
// vw: V[P][64][64] then W[P][64][64], int32 residues (xhat = x @ V).
__global__ void __launch_bounds__(BHAT_THREADS)
polymul_bhat_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ bhat,
                    const int32_t* __restrict__ vw,
                    const int64_t* __restrict__ consts,
                    int64_t* __restrict__ out, int64_t n, int64_t a_stride,
                    int64_t bhat_row_stride, int64_t bhat_prime_stride,
                    int P, int64_t q) {
  extern __shared__ int32_t tables[];              // V (P*D*D) then W
  __shared__ int64_t c_sh[N_CONSTS];
  __shared__ int32_t x_sh[BHAT_ROWS][D];
  const int table_len = 2 * P * D * D;
  for (int i = threadIdx.x; i < table_len; i += BHAT_THREADS)
    tables[i] = vw[i];
  const int n_consts = 3 * P + P * P + 1;
  for (int i = threadIdx.x; i < n_consts; i += BHAT_THREADS)
    c_sh[i] = consts[i];
  __syncthreads();
  const int32_t* V = tables;
  const int32_t* W = tables + P * D * D;
  const int64_t* primes = c_sh;
  const int64_t* ginv = c_sh + P;
  const int64_t* m_half = c_sh + P + P * P;
  const int64_t* prefix = m_half + P;
  const int64_t m_mod_q = prefix[P];

  const int r = threadIdx.x / D;
  const int k = threadIdx.x % D;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * BHAT_ROWS; row0 < n;
       row0 += static_cast<int64_t>(gridDim.x) * BHAT_ROWS) {
    const int64_t row = row0 + r;
    const bool live = row < n;
    const int64_t av = live ? a[row * a_stride + k] : 0;
    int64_t res[MAX_P];
#pragma unroll
    for (int pi = 0; pi < MAX_P; ++pi) {
      if (pi >= P) break;
      const int64_t p = primes[pi];
      const int32_t* Vp = V + pi * D * D;
      const int32_t* Wp = W + pi * D * D;
      x_sh[r][k] = static_cast<int32_t>(mod_pos(av, p));
      __syncthreads();
      int64_t acc = 0;
#pragma unroll 16
      for (int j = 0; j < D; ++j) acc += x_sh[r][j] * Vp[j * D + k];
      const int64_t xhat = acc % p;                // acc >= 0
      const int64_t bh = live
          ? mod_pos(bhat[pi * bhat_prime_stride + row * bhat_row_stride + k], p)
          : 0;
      __syncthreads();
      x_sh[r][k] = static_cast<int32_t>(xhat * bh % p);
      __syncthreads();
      acc = 0;
#pragma unroll 16
      for (int j = 0; j < D; ++j) acc += x_sh[r][j] * Wp[j * D + k];
      res[pi] = acc % p;
      __syncthreads();
    }
    // Garner: mixed-radix digits v_k in [0, p_k)
    int64_t v[MAX_P];
    v[0] = res[0];
#pragma unroll
    for (int kk = 1; kk < MAX_P; ++kk) {
      if (kk >= P) break;
      const int64_t p = primes[kk];
      int64_t t = mod_pos(res[kk] - v[0], p);
#pragma unroll
      for (int j = 1; j < MAX_P; ++j) {
        if (j >= kk) break;
        t = t * ginv[(j - 1) * P + kk] % p;
        t = mod_pos(t - v[j], p);
      }
      v[kk] = t * ginv[(kk - 1) * P + kk] % p;
    }
    // X mod q = sum_j v_j * (prod_{i<j} p_i mod q), minus M mod q where
    // the digits exceed floor(M/2)'s (most significant digit last)
    int64_t acc = 0;
    bool gt = false;
#pragma unroll
    for (int j = 0; j < MAX_P; ++j) {
      if (j >= P) break;
      acc += v[j] * prefix[j] % q;
      gt = (v[j] > m_half[j]) || (v[j] == m_half[j] && gt);
    }
    if (gt) acc -= m_mod_q;
    if (live) out[row * D + k] = mod_pos(acc, q);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" int polymul_coef_launch(const int64_t* a, const int64_t* b,
                                   int64_t* out, int64_t n, int64_t a_stride,
                                   int64_t b_stride, int64_t q,
                                   void* stream) {
  const int64_t tiles = (n + COEF_ROWS - 1) / COEF_ROWS;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  const unsigned blocks = static_cast<unsigned>(tiles < cap ? tiles : cap);
  polymul_coef_kernel<<<blocks, COEF_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n, a_stride, b_stride, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int polymul_bhat_launch(const int64_t* a, const int64_t* bhat,
                                   const int32_t* vw, const int64_t* consts,
                                   int64_t* out, int64_t n, int64_t a_stride,
                                   int64_t bhat_row_stride,
                                   int64_t bhat_prime_stride, int P,
                                   int64_t q, void* stream) {
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2) * P * D * D * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      polymul_bhat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + BHAT_ROWS - 1) / BHAT_ROWS;
  const int64_t cap = sm_count();
  const unsigned blocks = static_cast<unsigned>(tiles < cap ? tiles : cap);
  polymul_bhat_kernel<<<blocks, BHAT_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      a, bhat, vw, consts, out, n, a_stride, bhat_row_stride,
      bhat_prime_stride, P, q);
  return static_cast<int>(cudaGetLastError());
}

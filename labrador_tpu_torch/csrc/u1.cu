// The u1 outer commitment's B-term on int8 tensor cores, with the B
// matrices expanded in-kernel.
//
// Replaces labrador_tpu/ops/u1_pallas.py: u1_bterm_pallas (the pallas_call
// at line 164), small-q and big-q (line 104) branches.  Computes
//     out[row] = sum_{m < r*t_1} sum_{col < kappa} B_m[row][col] (*) t_m[col]
// mod q, as one stream over l = m * kappa + col (the digit stream of
// t_dig (t_1, r, kappa, d) with m = i * t_1 + k).  B_m[row][col][c] sits at
//     off_b + m * kappa_1 * kappa + row * kappa * d + col * d + c
// (structs.rs:74-88, the B stride without a factor d kept as in the
// reference).
//
// One GEMM whose CRS operand never exists in memory, taken transposed:
//     out^T (64 x kappa_1) = T^T (64 x 64L) . M^T (64L x kappa_1),
// M[row][64 l + i] the CRS entry, T^T[k][64 l + i] = sign(k >= i)
// t[l][(k - i) mod 64] the stacked negacyclic circulants of the digits.
// Each warp owns an 8-row tile of CRS rows: the n = 8 columns of
// mma.sync.m16n8k32.  Per half ring element (32 coefficients) each thread
// generates, with Threefry and a Barrett reduction, exactly the 8 entries
// that its B fragment holds (rows row0 + g, coefficients 4t..4t+3 and
// 16+4t..16+4t+3, g = lane / 4, t = lane % 4), splits them into unsigned
// 8-bit limbs packed in registers, and issues the products against the 4
// m-tiles of 16 output coefficients.  Every CRS entry is generated once
// over the grid and never goes through shared or global memory.  (Taken
// the other way round, the CRS as A with a 16-row tile per warp against
// 8 n-tiles, a thread would hold 32 int32 sums per limb weight instead of
// 16: 192 registers of sums at big q.)
//
// The circulant, the A operand, is built once per chunk of LC ring
// elements in shared memory as signed 8-bit limbs and read by every warp
// of the block.  An A register holds 4 consecutive coefficients i of one
// output coefficient k, which are the bytes rext[a..a+3], a = 63 - k + i,
// of the reversed doubled digits rext[p] = p < 64 ? t[63 - p] : -t[127 - p];
// a is not 4-aligned, so the chunk keeps 4 copies shifted by 0..3 bytes,
// each padded to 40 words so that the 4 copies a warp reads fall in
// distinct banks.
//
// Limbs (ops/u1_cuda.py names their counts; tests/test_torch_u1_mma.py
// models them against the plain version):
//   * entries: the canonical residue in [0, q).  Small q (q < 2^15): 2
//     unsigned limbs.  Big q (2^32 < q < 2^33): 5, four bytes and the top
//     bit; four 8-bit limbs cannot hold every residue of a q above 2^32
//     (centred, q/2 = 2^31 + 7 at q = 2^32 + 15 is beyond a signed 32-bit
//     value), so one scheme serves the whole big range;
//   * digits: DL signed limbs in [-128, 127] (the JAX package's
//     digit_limbs(b_1): 1 at b_1 <= 255), exact for |digit| <=
//     127 (256^DL - 1) / 255; the wrapper checks the operand against that
//     and raises outside it.  DL <= 4.
// Accumulation: the limb products of one weight w = a + b (entry limb a,
// digit limb b; at most min(EL, DL) <= 4 pairs) share an int32 fragment.
// Each mma adds 32 products of magnitude <= 255 * 128 = 32640, so a half
// ring element adds at most 4 * 32 * 32640 < 2^22 to a sum, and a flush
// every FLUSH_L = 256 ring elements (512 halves) keeps it below
// 512 * 4 * 32 * 32640 = 2,139,095,040 < 2^31 - 1.  At the flush
// sum_w 2^(8w) S_w is added exactly in int64 at small q (below 2^48) and
// at big q as sum_w (2^(8w) mod q) S_w in __int128 (each term below 2^64)
// reduced mod q.  Splits of the l stream write partials mod q; a second
// pass sums them (reduce_splits_kernel).
//
// What bounds it on the H100: Threefry (75 int32 operations per entry)
// plus the Barrett reduction and the limb split, on the CUDA cores; the
// tensor-core products are a few percent of that, global traffic only the
// digit stream.
// Shape limits (checked by ops/u1_cuda.py): d = 64, q <= 32513 or
// 2^32 < q < 2^33, r * t_1 * kappa below 2^31.
#include "threefry.cuh"

namespace {

constexpr int U1_LC = 16;          // ring elements per shared chunk
constexpr int U1_MAX_WARPS = 8;    // 8-row tiles per block
constexpr int U1_FLUSH_L = 256;    // ring elements between int32 flushes
constexpr int U1_COPY_WORDS = 40;  // a shifted copy: 32 words + padding
static_assert(U1_FLUSH_L * 2 * 4 * 32 * 32640LL <= 2147483647LL,
              "int32 limb sums may overflow between flushes");

// One mma.sync.m16n8k32: c (16 x 8, int32) += a (16 x 32 signed bytes) .
// b (32 x 8 unsigned bytes).
__device__ __forceinline__ void mma_s8u8(int32_t (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The EL unsigned limbs of 4 residues, byte j of each limb from e[j].
template <int EL>
__device__ __forceinline__ void pack_entry_limbs(const uint64_t (&e)[4],
                                                 uint32_t (&limb)[EL]) {
  const uint32_t w0 = static_cast<uint32_t>(e[0]);
  const uint32_t w1 = static_cast<uint32_t>(e[1]);
  const uint32_t w2 = static_cast<uint32_t>(e[2]);
  const uint32_t w3 = static_cast<uint32_t>(e[3]);
  const uint32_t p01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t p23 = __byte_perm(w2, w3, 0x5140);
  limb[0] = __byte_perm(p01, p23, 0x5410);
  limb[1] = __byte_perm(p01, p23, 0x7632);
  if constexpr (EL == 5) {
    const uint32_t h01 = __byte_perm(w0, w1, 0x7362);  // bytes 2 and 3
    const uint32_t h23 = __byte_perm(w2, w3, 0x7362);
    limb[2] = __byte_perm(h01, h23, 0x5410);
    limb[3] = __byte_perm(h01, h23, 0x7632);
    limb[4] = static_cast<uint32_t>(e[0] >> 32) |
              static_cast<uint32_t>(e[1] >> 32) << 8 |
              static_cast<uint32_t>(e[2] >> 32) << 16 |
              static_cast<uint32_t>(e[3] >> 32) << 24;
  }
}

// res += sum_w 2^(8w) acc[w] mod q (in (-q, q) at small q, [0, q) at big
// q); acc = 0.  The bounds are at the top.
template <int EL, int NW>
__device__ __forceinline__ void u1_flush(int32_t (&acc)[NW][4][4],
                                         int64_t (&res)[4][4], int64_t q) {
  // 2^64 mod q, and cw[w] = 2^(8w) mod q < 2^33 (each term of the big-q
  // sum below is then below 2^64)
  const uint64_t uq = static_cast<uint64_t>(q);
  const int64_t c64 = static_cast<int64_t>((0 - uq) % uq);
  int64_t cw[NW];
  cw[0] = 1;
#pragma unroll
  for (int w = 1; w < NW; ++w) cw[w] = (cw[w - 1] << 8) % q;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (EL == 2) {
        int64_t v = res[mt][c];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          v += static_cast<int64_t>(acc[w][mt][c]) * (int64_t{1} << (8 * w));
        res[mt][c] = v % q;
      } else {
        __int128 v = res[mt][c];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          v += static_cast<__int128>(cw[w]) * acc[w][mt][c];
        res[mt][c] = mod_i128(v, q, c64);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w][mt][c] = 0;
    }
  }
}

// part[s][0][row][k] = (sum over split s of B(l, row) (*) t[l])[k] mod q.
// EL entry limbs (2: small q, 5: big q), DL digit limbs.
template <int EL, int DL>
__global__ void __launch_bounds__(U1_MAX_WARPS * 32)
u1_mma_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
              int L, int kappa, int kappa1, int64_t q, uint64_t barrett_m,
              uint64_t off_b, uint32_t k0, uint32_t k1, int l_per_split) {
  constexpr int NW = EL + DL - 1;  // limb weights
  __shared__ int32_t dsh[U1_LC][D];
  __shared__ uint32_t circ[U1_LC][DL][4][U1_COPY_WORDS];
  const int nthreads = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = (blockIdx.y * (nthreads >> 5) + (threadIdx.x >> 5)) * 8;
  const int row = row0 + g;            // the CRS row of this B column
  const bool row_ok = row < kappa1;
  const int s = blockIdx.x;
  const int l_begin = s * l_per_split;
  const int l_end = min(L, l_begin + l_per_split);
  const int64_t half_q = q / 2;
  const uint64_t uq = static_cast<uint64_t>(q);
  int32_t acc[NW][4][4];
  int64_t res[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      res[mt][c] = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w][mt][c] = 0;
    }
  }

  int lm = l_begin / kappa, lc = l_begin % kappa;   // l = lm * kappa + lc
  int since_flush = 0;
  for (int l0 = l_begin; l0 < l_end; l0 += U1_LC) {
    const int nl = min(U1_LC, l_end - l0);
    for (int e = threadIdx.x; e < U1_LC * D; e += nthreads) {
      const int l = e / D, c = e % D;
      int32_t v = 0;
      if (l < nl) {
        const int64_t x = dig[static_cast<int64_t>(l0 + l) * D + c];
        v = static_cast<int32_t>(x > half_q ? x - q : x);
      }
      dsh[l][c] = v;
    }
    __syncthreads();
    // circ[l][b][sh][w]: limb b of rext[4w + sh + j] in byte j
    for (int e = threadIdx.x; e < U1_LC * 4 * 32; e += nthreads) {
      const int w = e & 31, sh = (e >> 5) & 3, l = e >> 7;
      uint32_t word[DL];
#pragma unroll
      for (int b = 0; b < DL; ++b) word[b] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * w + sh + j;
        int32_t v = 0;
        if (p < 64) {
          v = dsh[l][63 - p];
        } else if (p < 128) {
          v = -dsh[l][127 - p];
        }
#pragma unroll
        for (int b = 0; b < DL; ++b) {
          const int32_t limb = ((v + 128) & 255) - 128;
          word[b] |= static_cast<uint32_t>(limb & 255) << (8 * j);
          v = (v - limb) >> 8;
        }
      }
#pragma unroll
      for (int b = 0; b < DL; ++b) circ[l][b][sh][w] = word[b];
    }
    __syncthreads();
    for (int l = 0; l < nl; ++l) {
      const uint64_t base = off_b +
          static_cast<uint64_t>(lm) * kappa1 * kappa +
          static_cast<uint64_t>(row) * kappa * D +
          static_cast<uint64_t>(lc) * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bl[2][EL];          // B fragment limbs: k 4t.., 16+4t..
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i0 = 32 * h + 16 * r + 4 * tq;
          uint64_t e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            e[j] = row_ok ? static_cast<uint64_t>(crs_coeff(
                       k0, k1, base + i0 + j, uq, barrett_m))
                          : 0;
          }
          pack_entry_limbs<EL>(e, bl[r]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t al[DL][4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            // A fragment: k = 16 mt + g (+8), i = 32 h + 4 t (+16)
            const int a = 63 - (16 * mt + g + 8 * (rr & 1)) +
                          (32 * h + 4 * tq + 16 * (rr >> 1));
#pragma unroll
            for (int b = 0; b < DL; ++b) al[b][rr] = circ[l][b][a & 3][a >> 2];
          }
#pragma unroll
          for (int ea = 0; ea < EL; ++ea) {
#pragma unroll
            for (int b = 0; b < DL; ++b) {
              mma_s8u8(acc[ea + b][mt], al[b], bl[0][ea], bl[1][ea]);
            }
          }
        }
      }
      if (++lc == kappa) {
        lc = 0;
        ++lm;
      }
      if (++since_flush == U1_FLUSH_L) {
        u1_flush<EL, NW>(acc, res, q);
        since_flush = 0;
      }
    }
    __syncthreads();
  }
  u1_flush<EL, NW>(acc, res, q);

  // c[0..3] of m-tile mt: coefficient 16 mt + g (+8 for c >= 2), CRS row
  // row0 + 2 t (+1 for odd c)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = row0 + 2 * tq + (c & 1);
      const int k = 16 * mt + g + 8 * (c >> 1);
      int64_t v = res[mt][c];
      if (v < 0) v += q;
      if (n < kappa1) {
        part[(static_cast<int64_t>(s) * kappa1 + n) * D + k] = v;
      }
    }
  }
}

template <int EL, int DL>
cudaError_t launch_u1(const int64_t* dig, int64_t* part, int L, int kappa,
                      int kappa1, int64_t q, uint64_t barrett_m,
                      uint64_t off_b, uint32_t k0, uint32_t k1, int warps,
                      int splits, int l_per_split, cudaStream_t stream) {
  const dim3 grid(splits, (kappa1 + 8 * warps - 1) / (8 * warps));
  u1_mma_kernel<EL, DL><<<grid, 32 * warps, 0, stream>>>(
      dig, part, L, kappa, kappa1, q, barrett_m, off_b, k0, k1, l_per_split);
  return cudaGetLastError();
}

}  // namespace

// Returns the first launch error; cudaErrorInvalidValue for a mode the
// kernel does not take (the wrapper raises before that).
extern "C" int u1_bterm_launch(const int64_t* t_stream, int64_t* part,
                               int64_t* out, int m_total, int kappa,
                               int kappa1, int64_t q, uint64_t barrett_m,
                               uint64_t off_b, uint32_t k0, uint32_t k1,
                               int digit_limbs, int warps, int splits,
                               int l_per_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = m_total * kappa;
  if (warps < 1 || warps > U1_MAX_WARPS) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
#define LAB_U1(EL, DL)                                                     \
  err = launch_u1<EL, DL>(t_stream, part, L, kappa, kappa1, q, barrett_m, \
                          off_b, k0, k1, warps, splits, l_per_split, st)
  if (q <= SMALL_Q_MAX) {
    if (digit_limbs == 1) LAB_U1(2, 1);
    else if (digit_limbs == 2) LAB_U1(2, 2);
  } else {
    if (digit_limbs == 1) LAB_U1(5, 1);
    else if (digit_limbs == 2) LAB_U1(5, 2);
    else if (digit_limbs == 3) LAB_U1(5, 3);
    else if (digit_limbs == 4) LAB_U1(5, 4);
  }
#undef LAB_U1
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(kappa1) * D;
  reduce_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         st>>>(part, out, splits, n, q);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core stream kernel of the u1 B-term (u1.cu) and the C/D sums
// (cd.cu): CRS entries generated in-kernel straight into int8 mma.sync
// fragments.
//
// Both commitments compute
//     out[row] = sum_{l < L} M(l, row) (*) dig[l]   mod q
// over a stream of L digit polynomials, (*) the negacyclic product in
// Zq[X]/(X^64 + 1), M(l, row) the ring element of the virtual CRS at the
// offset off.stream(l) + off.row(row) that the kernel's offset functor
// gives (64 consecutive Threefry counters from there).  They differ only
// in that offset.  The stream term, which divides l, is computed once per
// ring element and block into shared memory; the row term once per
// thread.
//
// One GEMM whose CRS operand never exists in memory, taken transposed:
//     out^T (64 x rows) = T^T (64 x 64L) . M^T (64L x rows),
// M[row][64 l + i] the CRS entry, T^T[k][64 l + i] = sign(k >= i)
// dig[l][(k - i) mod 64] the stacked negacyclic circulants of the digits.
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
// The circulant, the A operand, is built once per chunk of MMA_LC ring
// elements in shared memory as signed 8-bit limbs and read by every warp
// of the block.  An A register holds 4 consecutive coefficients i of one
// output coefficient k, which are the bytes rext[a..a+3], a = 63 - k + i,
// of the reversed doubled digits rext[p] = p < 64 ? t[63 - p] : -t[127 - p];
// a is not 4-aligned, so the chunk keeps 4 copies shifted by 0..3 bytes,
// each padded to 40 words so that the 4 copies a warp reads fall in
// distinct banks.
//
// Launch shape (ops/u1_cuda.py launch_shape): grid (splits, row blocks); a
// block holds `tiles` 8-row tiles times `groups` warps each.  With few
// rows (kappa' = 16 after a fold: 2 tiles), or a stream too short to fill
// the card with splits (the 2^14 C-term: 136 ring elements), the block's
// warps split the ring elements of each chunk among `groups` l-groups, so
// that a block of 8 warps still shares one circulant; the groups' sums of
// the same rows are added in shared memory (64-bit atomics, residues
// below q: at most 8 terms below 2^36) before the block writes its
// partial.  Splits of the l stream write partials mod q; a second pass
// sums them (reduce_splits_kernel).
//
// Limbs (ops/u1_cuda.py names their counts; tests/test_torch_u1_mma.py
// models them against the plain versions):
//   * entries: the canonical residue in [0, q).  Small q (q < 2^15): 2
//     unsigned limbs.  Big q (2^32 < q < 2^33): 5, four bytes and the top
//     bit; four 8-bit limbs cannot hold every residue of a q above 2^32
//     (centred, q/2 = 2^31 + 7 at q = 2^32 + 15 is beyond a signed 32-bit
//     value), so one scheme serves the whole big range;
//   * digits: DL signed limbs in [-128, 127] (the JAX package's
//     digit_limbs(b) of the digit base: 1 at b <= 255), exact for |digit|
//     <= 127 (256^DL - 1) / 255.  DL <= 4.  The kernel checks each centred
//     digit against that bound as it loads it, at no extra pass over the
//     stream, and sets *bad for one beyond it; the wrappers read the flag
//     after the launch (one device sync) and raise.
// Accumulation: the limb products of one weight w = a + b (entry limb a,
// digit limb b; at most min(EL, DL) <= 4 pairs) share an int32 fragment.
// Each mma adds 32 products of magnitude <= 255 * 128 = 32640, so a half
// ring element adds at most 4 * 32 * 32640 < 2^22 to a sum, and a flush
// after every MMA_FLUSH_L = 256 ring elements that a warp adds (whatever
// its l-group) keeps it below 512 * 4 * 32 * 32640 = 2,139,095,040 <
// 2^31 - 1.  At the flush sum_w 2^(8w) S_w is added exactly in int64 at
// small q (below 2^48) and at big q as sum_w (2^(8w) mod q) S_w in
// __int128 (each term below 2^64) reduced mod q.
//
// What bounds it on the H100: Threefry (75 int32 operations per entry)
// plus the Barrett reduction and the limb split, on the CUDA cores; the
// tensor-core products are a few percent of that, global traffic only the
// digit stream.
#pragma once

#include "threefry.cuh"

namespace {

constexpr int MMA_LC = 16;          // ring elements per shared chunk
constexpr int MMA_MAX_WARPS = 8;    // warps per block
constexpr int MMA_FLUSH_L = 256;    // ring elements between int32 flushes
constexpr int MMA_COPY_WORDS = 40;  // a shifted copy: 32 words + padding
// row tiles of a block whose warps split the ring elements (groups > 1)
constexpr int MMA_MAX_GROUP_TILES = MMA_MAX_WARPS / 2;
static_assert(MMA_FLUSH_L * 2 * 4 * 32 * 32640LL <= 2147483647LL,
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
// q); acc = 0; MT m-tiles, res int64 or (small q) int32.  The bounds are
// at the top (and in ajtai.cu).
template <int EL, int NW, int MT = 4, class R = int64_t>
__device__ __forceinline__ void mma_flush(int32_t (&acc)[NW][MT][4],
                                          R (&res)[MT][4], int64_t q) {
  // 2^64 mod q, and cw[w] = 2^(8w) mod q < 2^33 (each term of the big-q
  // sum below is then below 2^64)
  const uint64_t uq = static_cast<uint64_t>(q);
  const int64_t c64 = static_cast<int64_t>((0 - uq) % uq);
  int64_t cw[NW];
  cw[0] = 1;
#pragma unroll
  for (int w = 1; w < NW; ++w) cw[w] = (cw[w - 1] << 8) % q;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (EL == 2) {
        int64_t v = res[mt][c];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          v += static_cast<int64_t>(acc[w][mt][c]) * (int64_t{1} << (8 * w));
        res[mt][c] = static_cast<R>(v % q);
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

// The block's shared memory: the digit chunk and its circulant limbs
// while the stream runs, then the l-groups' sums of the block's rows.
template <int DL>
union MmaShared {
  struct {
    int32_t dsh[MMA_LC][D];
    uint32_t circ[MMA_LC][DL][4][MMA_COPY_WORDS];
    uint64_t loff[MMA_LC];   // off.stream(l) of the chunk's ring elements
  } s;
  unsigned long long red[MMA_MAX_GROUP_TILES * 8][D];
};

// part[s][row][k] = (sum over split s of M(l, row) (*) dig[l])[k] mod q.
// EL entry limbs (2: small q, 5: big q), DL digit limbs; off.stream(l) +
// off.row(row) the CRS offset of coefficient 0 of M(l, row).
template <int EL, int DL, class Off>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
mma_stream_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
                  int* __restrict__ bad, int L, int rows, int64_t q,
                  uint64_t barrett_m, uint32_t k0, uint32_t k1, Off off,
                  int tiles, int l_per_split) {
  constexpr int NW = EL + DL - 1;  // limb weights
  // the largest |digit| that DL signed limbs hold for x and -x alike
  constexpr int64_t cover = 127 * ((int64_t{1} << (8 * DL)) - 1) / 255;
  __shared__ MmaShared<DL> sh;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int groups = (nthreads >> 5) / tiles;
  const int tile = warp % tiles, grp = warp / tiles;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = (blockIdx.y * tiles + tile) * 8;
  const int row = row0 + g;            // the CRS row of this B column
  const bool row_ok = row < rows;
  const uint64_t row_off = off.row(row);
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

  int since_flush = 0;
  bool beyond = false;
  for (int l0 = l_begin; l0 < l_end; l0 += MMA_LC) {
    const int nl = min(MMA_LC, l_end - l0);
    for (int e = threadIdx.x; e < MMA_LC * D; e += nthreads) {
      const int l = e / D, c = e % D;
      int32_t v = 0;
      if (l < nl) {
        const int64_t x = dig[static_cast<int64_t>(l0 + l) * D + c];
        const int64_t centred = x > half_q ? x - q : x;
        beyond |= centred > cover || centred < -cover;
        v = static_cast<int32_t>(centred);
      }
      sh.s.dsh[l][c] = v;
    }
    if (threadIdx.x < nl) {
      sh.s.loff[threadIdx.x] = off.stream(l0 + threadIdx.x);
    }
    __syncthreads();
    // circ[l][b][sh][w]: limb b of rext[4w + sh + j] in byte j
    for (int e = threadIdx.x; e < MMA_LC * 4 * 32; e += nthreads) {
      const int w = e & 31, shift = (e >> 5) & 3, l = e >> 7;
      uint32_t word[DL];
#pragma unroll
      for (int b = 0; b < DL; ++b) word[b] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * w + shift + j;
        int32_t v = 0;
        if (p < 64) {
          v = sh.s.dsh[l][63 - p];
        } else if (p < 128) {
          v = -sh.s.dsh[l][127 - p];
        }
#pragma unroll
        for (int b = 0; b < DL; ++b) {
          const int32_t limb = ((v + 128) & 255) - 128;
          word[b] |= static_cast<uint32_t>(limb & 255) << (8 * j);
          v = (v - limb) >> 8;
        }
      }
#pragma unroll
      for (int b = 0; b < DL; ++b) sh.s.circ[l][b][shift][w] = word[b];
    }
    __syncthreads();
    for (int l = grp; l < nl; l += groups) {
      const uint64_t base = sh.s.loff[l] + row_off;
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
            for (int b = 0; b < DL; ++b)
              al[b][rr] = sh.s.circ[l][b][a & 3][a >> 2];
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
      if (++since_flush == MMA_FLUSH_L) {
        mma_flush<EL, NW>(acc, res, q);
        since_flush = 0;
      }
    }
    __syncthreads();
  }
  mma_flush<EL, NW>(acc, res, q);
  if (beyond) atomicOr(bad, 1);

  // c[0..3] of m-tile mt: coefficient 16 mt + g (+8 for c >= 2), CRS row
  // row0 + 2 t (+1 for odd c)
  if (groups == 1) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = row0 + 2 * tq + (c & 1);
        const int k = 16 * mt + g + 8 * (c >> 1);
        int64_t v = res[mt][c];
        if (v < 0) v += q;
        if (n < rows) {
          part[(static_cast<int64_t>(s) * rows + n) * D + k] = v;
        }
      }
    }
    return;
  }
  // several l-groups: their sums of the block's rows meet in shared
  // memory (the chunk buffers are free after the loop's last barrier)
  const int block_rows = tiles * 8;
  for (int e = threadIdx.x; e < block_rows * D; e += nthreads)
    sh.red[e / D][e % D] = 0;
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = tile * 8 + 2 * tq + (c & 1);
      const int k = 16 * mt + g + 8 * (c >> 1);
      int64_t v = res[mt][c];
      if (v < 0) v += q;
      atomicAdd(&sh.red[n][k], static_cast<unsigned long long>(v));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < block_rows * D; e += nthreads) {
    const int n = blockIdx.y * block_rows + e / D;
    if (n < rows) {
      part[(static_cast<int64_t>(s) * rows + n) * D + e % D] =
          static_cast<int64_t>(sh.red[e / D][e % D] % uq);
    }
  }
}

template <int EL, int DL, class Off>
cudaError_t launch_mma(const int64_t* dig, int64_t* part, int* bad, int L,
                       int rows, int64_t q, uint64_t barrett_m, uint32_t k0,
                       uint32_t k1, Off off, int tiles, int groups,
                       int splits, int l_per_split, cudaStream_t stream) {
  const dim3 grid(splits, (rows + 8 * tiles - 1) / (8 * tiles));
  mma_stream_kernel<EL, DL, Off><<<grid, 32 * tiles * groups, 0, stream>>>(
      dig, part, bad, L, rows, q, barrett_m, k0, k1, off, tiles,
      l_per_split);
  return cudaGetLastError();
}

// The stream kernel in the mode of q and digit_limbs, then the split
// reduction into out (rows, D); *bad is zeroed first and set for a digit
// beyond the limbs.  Returns the first launch error, or
// cudaErrorInvalidValue for a mode or a shape the kernel does not take
// (the wrappers raise before that).
template <class Off>
cudaError_t launch_mma_stream(const int64_t* dig, int64_t* part,
                              int64_t* out, int* bad, int L, int rows,
                              int64_t q, uint64_t barrett_m, uint32_t k0,
                              uint32_t k1, Off off, int digit_limbs,
                              int tiles, int groups, int splits,
                              int l_per_split, cudaStream_t st) {
  if (tiles < 1 || groups < 1 || tiles * groups > MMA_MAX_WARPS ||
      (groups > 1 && tiles > MMA_MAX_GROUP_TILES) || splits < 1 ||
      l_per_split % MMA_LC != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
#define LAB_MMA(EL, DL)                                                  \
  err = launch_mma<EL, DL, Off>(dig, part, bad, L, rows, q, barrett_m, k0, \
                                k1, off, tiles, groups, splits, l_per_split, \
                                st)
  if (q <= SMALL_Q_MAX) {
    if (digit_limbs == 1) LAB_MMA(2, 1);
    else if (digit_limbs == 2) LAB_MMA(2, 2);
  } else {
    if (digit_limbs == 1) LAB_MMA(5, 1);
    else if (digit_limbs == 2) LAB_MMA(5, 2);
    else if (digit_limbs == 3) LAB_MMA(5, 3);
    else if (digit_limbs == 4) LAB_MMA(5, 4);
  }
#undef LAB_MMA
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(rows) * D;
  reduce_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         st>>>(part, out, splits, n, q);
  return cudaGetLastError();
}

}  // namespace

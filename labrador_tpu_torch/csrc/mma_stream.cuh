// The tensor-core stream kernel of the u1 B-term (u1.cu), the C/D sums
// (cd.cu) and the alpha-contractions of a folded statement (alpha.cu): CRS
// entries generated in-kernel straight into int8 mma.sync fragments.
//
// Each computes
//     out[row] = sum_{l < L} M(l, row) (*) dig[l]   mod q
// over a stream of L digit polynomials, (*) the negacyclic product in
// Zq[X]/(X^64 + 1), M(l, row) the ring element of the virtual CRS at the
// offset off.stream(l) + off.row(row) that the kernel's offset functor
// gives (64 consecutive Threefry counters from there).  They differ in
// that offset, and the alpha-contractions in their operand (below).  The
// stream term, which divides l, is computed once per ring element and
// block into shared memory; the row term once per thread.
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
// Launch shape (ops/u1_cuda.py launch_shape): grid (splits, row blocks,
// instances); a block holds `tiles` 8-row tiles times `groups` warps
// each.  With few
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
//     after the launch (one device sync) and raise;
//   * full residues (an offset functor that derives from
//     FullResidueOperand: the alpha weights of alpha.cu, any residue in
//     [0, q)): as many signed limbs as entry limbs, DL = EL, which hold
//     every centred residue (|x| <= q/2 <= 16256 in 2 limbs at small q;
//     |x| <= 2^32 in 5 at big q, beyond the 2,139,062,143 of 4), so no
//     check and no flag.  At big q a centred residue does not fit int32:
//     the digit chunk holds int64 there, and takes MMA_LC / 2 ring
//     elements so that the block stays within 48 KB of static shared
//     memory (29,760 B; 16 ring elements would take 59,520 B).
// Accumulation: the limb products of one weight w = a + b (entry limb a,
// digit limb b; at most P = min(EL, DL) pairs) share an int32 fragment.
// Each mma adds 32 products of magnitude <= 255 * 128 = 32640, so a ring
// element (two halves) adds at most 2 * P * 32 * 32640 to a sum, and a
// flush after every F = mma_flush_len(P) ring elements that a warp adds
// (whatever its l-group) keeps it within 2 F P 32 32640 <= 2^31 - 1: F =
// 256 at P <= 4 (2,139,095,040), 128 at P = 5 (1,336,934,400; 256 would
// reach 2,673,868,800).  At the flush sum_w 2^(8w) S_w is added exactly
// in int64 at small q (below 2^48) and at big q as sum_w (2^(8w) mod q)
// S_w in __int128 (each term below 2^64) reduced mod q.
//
// What bounds it on the H100: Threefry (75 int32 operations per entry)
// plus the Barrett reduction and the limb split, on the CUDA cores; the
// tensor-core products are a few percent of that, global traffic only the
// digit stream.
//
// Batch mode: `instances` independent instances in one launch (the JAX
// package's vmap of the commitment over (B, 2) CRS keys), grid.z the
// instance: a block binds its source to its instance's CRS key
// (ThreefrySrc::at) and reads that instance's digit stream at dig +
// instance * inst_stride; the offsets (off) are the same for every
// instance.  Partials, results and the digit flag are per instance (part
// (splits, instances, rows, D), out (instances, rows, D), bad
// (instances)), so the wrappers read every instance's flag with one
// device sync and name the instance.  A single instance is a batch of
// one.  Each instance has its own CRS, so a batch shares no Threefry
// work: its time is about the instances' sum, less the launches.
//
// Table mode (Src = TableSrc, small q only): each entry is read from the
// flat table of a crs.MaterializedCRS at the same offset instead of
// generated; everything after the entry (limbs, products, flushes) is the
// same.  Each thread reads its fragment's 4 consecutive entries with 4
// scalar loads; B matrices that overlap in the layout (structs.rs:82: the
// stride kappa_1 * kappa has no factor d) read the same entries many
// times, and their distinct entries fit the 50 MB L2 at 2^14 (41.7 MB).
#pragma once

#include <type_traits>

#include "threefry.cuh"

namespace {

constexpr int MMA_LC = 16;          // ring elements per shared chunk
constexpr int MMA_MAX_WARPS = 8;    // warps per block
constexpr int MMA_FLUSH_L = 256;    // most ring elements between flushes
constexpr int MMA_COPY_WORDS = 40;  // a shifted copy: 32 words + padding
// row tiles of a block whose warps split the ring elements (groups > 1)
constexpr int MMA_MAX_GROUP_TILES = MMA_MAX_WARPS / 2;

// Ring elements a warp adds between int32 flushes with `pairs` limb pairs
// a weight: the largest power of two up to MMA_FLUSH_L with 2 F pairs 32
// 32640 <= 2^31 - 1 (the bound at the top).
__host__ __device__ constexpr int mma_flush_len(int pairs) {
  int f = MMA_FLUSH_L;
  while (2LL * f * pairs * 32 * 32640 > 2147483647LL) f /= 2;
  return f;
}
static_assert(mma_flush_len(4) == MMA_FLUSH_L && mma_flush_len(5) == 128,
              "int32 limb sums may overflow between flushes");

// The operand kind of the alpha-contractions' offset functors (alpha.cu):
// full residues, DL = EL limbs and no digit check.
struct FullResidueOperand {};

// A digit of the shared chunk: int32 up to 4 limbs, int64 for the 5 of a
// full residue at big q; the chunk's ring elements.
template <int DL>
using MmaDigit = std::conditional_t<(DL > 4), int64_t, int32_t>;
template <int DL>
__host__ __device__ constexpr int mma_chunk() {
  return DL > 4 ? MMA_LC / 2 : MMA_LC;
}

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
    MmaDigit<DL> dsh[mma_chunk<DL>()][D];
    uint32_t circ[mma_chunk<DL>()][DL][4][MMA_COPY_WORDS];
    uint64_t loff[mma_chunk<DL>()];   // off.stream(l) of the chunk's l
  } s;
  unsigned long long red[MMA_MAX_GROUP_TILES * 8][D];
};

// part[s][b][row][k] = (sum over split s of M_b(l, row) (*) dig_b[l])[k]
// mod q for instance b = blockIdx.z, dig_b the stream at dig + b *
// inst_stride.  EL entry limbs (2: small q, 5: big q), DL digit limbs;
// off.stream(l) + off.row(row) the CRS offset of coefficient 0 of M(l,
// row), src_all.at(b)(offset) instance b's entry there (threefry.cuh:
// ThreefrySrc or TableSrc).  For an Off that derives from
// FullResidueOperand nothing is checked and bad is not written.
template <int EL, int DL, class Off, class Src>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
mma_stream_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
                  int* __restrict__ bad, int L, int rows, int64_t q,
                  Src src_all, int64_t inst_stride, Off off, int tiles,
                  int l_per_split) {
  constexpr int NW = EL + DL - 1;  // limb weights
  constexpr int LC = mma_chunk<DL>();
  constexpr int FLUSH = mma_flush_len(EL < DL ? EL : DL);
  constexpr bool FULL = std::is_base_of_v<FullResidueOperand, Off>;
  using Dig = MmaDigit<DL>;
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
  const int inst = blockIdx.z;
  const Src src = src_all.at(inst);
  dig += inst * inst_stride;
  // this instance's rows of split s's partial
  part += (static_cast<int64_t>(s) * gridDim.z + inst) * rows * D;
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
  for (int l0 = l_begin; l0 < l_end; l0 += LC) {
    const int nl = min(LC, l_end - l0);
    for (int e = threadIdx.x; e < LC * D; e += nthreads) {
      const int l = e / D, c = e % D;
      Dig v = 0;
      if (l < nl) {
        const int64_t x = dig[static_cast<int64_t>(l0 + l) * D + c];
        const int64_t centred = x > half_q ? x - q : x;
        if constexpr (!FULL) {
          beyond |= centred > cover || centred < -cover;
        }
        v = static_cast<Dig>(centred);
      }
      sh.s.dsh[l][c] = v;
    }
    if (threadIdx.x < nl) {
      sh.s.loff[threadIdx.x] = off.stream(l0 + threadIdx.x);
    }
    __syncthreads();
    // circ[l][b][sh][w]: limb b of rext[4w + sh + j] in byte j
    for (int e = threadIdx.x; e < LC * 4 * 32; e += nthreads) {
      const int w = e & 31, shift = (e >> 5) & 3, l = e >> 7;
      uint32_t word[DL];
#pragma unroll
      for (int b = 0; b < DL; ++b) word[b] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * w + shift + j;
        Dig v = 0;
        if (p < 64) {
          v = sh.s.dsh[l][63 - p];
        } else if (p < 128) {
          v = -sh.s.dsh[l][127 - p];
        }
#pragma unroll
        for (int b = 0; b < DL; ++b) {
          const Dig limb = ((v + 128) & 255) - 128;
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
            e[j] = row_ok ? src(base + i0 + j) : 0;
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
      if (++since_flush == FLUSH) {
        mma_flush<EL, NW>(acc, res, q);
        since_flush = 0;
      }
    }
    __syncthreads();
  }
  mma_flush<EL, NW>(acc, res, q);
  if constexpr (!FULL) {
    if (beyond) atomicOr(bad + inst, 1);
  }

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
          part[static_cast<int64_t>(n) * D + k] = v;
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
      part[static_cast<int64_t>(n) * D + e % D] =
          static_cast<int64_t>(sh.red[e / D][e % D] % uq);
    }
  }
}

template <int EL, int DL, class Off, class Src>
cudaError_t launch_mma(const int64_t* dig, int64_t* part, int* bad, int L,
                       int rows, int64_t q, Src src, int instances,
                       int64_t inst_stride, Off off, int tiles, int groups,
                       int splits, int l_per_split, cudaStream_t stream) {
  const dim3 grid(splits, (rows + 8 * tiles - 1) / (8 * tiles), instances);
  mma_stream_kernel<EL, DL, Off, Src>
      <<<grid, 32 * tiles * groups, 0, stream>>>(dig, part, bad, L, rows, q,
                                                 src, inst_stride, off,
                                                 tiles, l_per_split);
  return cudaGetLastError();
}

// A launch shape and instance count the kernel takes (ops/u1_cuda.py
// launch_shape gives them).
inline bool mma_shape_ok(int tiles, int groups, int splits, int l_per_split,
                         int instances) {
  return tiles >= 1 && groups >= 1 && tiles * groups <= MMA_MAX_WARPS &&
         (groups == 1 || tiles <= MMA_MAX_GROUP_TILES) && splits >= 1 &&
         l_per_split % MMA_LC == 0 && instances >= 1 && instances <= 65535;
}

// The second pass: out (n entries) = the sum of the splits' partials.
inline cudaError_t launch_reduce_splits(const int64_t* part, int64_t* out,
                                        int splits, int64_t n, int64_t q,
                                        cudaStream_t st) {
  reduce_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         st>>>(part, out, splits, n, q);
  return cudaGetLastError();
}

// The stream kernel in the mode of q and digit_limbs over `instances`
// instances (instance b: key src.at(b), digits at dig + b * inst_stride),
// then the split reduction into out (instances, rows, D); bad[0 ..
// instances) is zeroed first and bad[b] set for a digit of instance b
// beyond the limbs.  Returns the first launch error, or
// cudaErrorInvalidValue for a mode or a shape the kernel does not take
// (the wrappers raise before that; a TableSrc at big q is one).
template <class Off, class Src>
cudaError_t launch_mma_stream(const int64_t* dig, int64_t* part,
                              int64_t* out, int* bad, int L, int rows,
                              int64_t q, Src src, int instances,
                              int64_t inst_stride, Off off, int digit_limbs,
                              int tiles, int groups, int splits,
                              int l_per_split, cudaStream_t st) {
  if (!mma_shape_ok(tiles, groups, splits, l_per_split, instances)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int) * instances, st);
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
#define LAB_MMA(EL, DL)                                                  \
  err = launch_mma<EL, DL, Off, Src>(dig, part, bad, L, rows, q, src,     \
                                     instances, inst_stride, off, tiles,  \
                                     groups, splits, l_per_split, st)
  if (q <= SMALL_Q_MAX) {
    if (digit_limbs == 1) LAB_MMA(2, 1);
    else if (digit_limbs == 2) LAB_MMA(2, 2);
  } else if constexpr (Src::BIG_OK) {
    if (digit_limbs == 1) LAB_MMA(5, 1);
    else if (digit_limbs == 2) LAB_MMA(5, 2);
    else if (digit_limbs == 3) LAB_MMA(5, 3);
    else if (digit_limbs == 4) LAB_MMA(5, 4);
  }
#undef LAB_MMA
  if (err != cudaSuccess) return err;
  return launch_reduce_splits(part, out, splits,
                              static_cast<int64_t>(instances) * rows * D, q,
                              st);
}

// The stream kernel over one Threefry instance whose operand is full
// residues (Off derives from FullResidueOperand: residues in [0, q), or
// any value whose centred residue is at most q/2 in magnitude): DL = EL,
// 2 limbs at small q and 5 at big q, no digit check and no flag; then the
// split reduction into out (rows, D).  Returns the first launch error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
template <class Off>
cudaError_t launch_mma_full(const int64_t* dig, int64_t* part, int64_t* out,
                            int L, int rows, int64_t q, ThreefrySrc src,
                            Off off, int tiles, int groups, int splits,
                            int l_per_split, cudaStream_t st) {
  static_assert(std::is_base_of_v<FullResidueOperand, Off>,
                "launch_mma_full takes the offsets of a full-residue operand");
  if (!mma_shape_ok(tiles, groups, splits, l_per_split, 1)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      q <= SMALL_Q_MAX
          ? launch_mma<2, 2, Off, ThreefrySrc>(dig, part, nullptr, L, rows, q,
                                               src, 1, 0, off, tiles, groups,
                                               splits, l_per_split, st)
          : launch_mma<5, 5, Off, ThreefrySrc>(dig, part, nullptr, L, rows, q,
                                               src, 1, 0, off, tiles, groups,
                                               splits, l_per_split, st);
  if (err != cudaSuccess) return err;
  return launch_reduce_splits(part, out, splits,
                              static_cast<int64_t>(rows) * D, q, st);
}

}  // namespace

// Ajtai commitment t = A s on int8 tensor cores, with the virtual CRS
// matrix A expanded in-kernel.
//
// Replaces labrador_tpu/ops/ajtai_pallas.py: ajtai_commit_pallas (the
// pallas_call at line 234), its small-q and its big-q branch (line 173).
// Computes, for every witness vector j < r_eff and row < kappa,
//     t[j][row] = sum_{l < n} A[row][l] (*) s[j][l]   mod q,
// A[row][l][c] at CRS offset row * n * d + l * d + c (structs.rs:55-72).
// Range mode: the rows row0 .. row0 + rows - 1 of A only (one shard of
// the kappa axis, the rows of a (dp, rows) mesh; out (r_eff, rows, d)),
// the TPU's per-device A row block of the JAX package's sharded Ajtai;
// row0 = 0, rows = kappa is the whole commitment.
// Table mode (ajtai_commit_table_launch, small q only): the entries of A
// read from a crs.MaterializedCRS's table at the same offsets (TableSrc,
// threefry.cuh) instead of generated; the rest is the same.
// Batch mode: `instances` independent instances in one launch (the JAX
// package's vmap of the commitment over (B, 2) CRS keys), each with its
// own CRS key (ThreefrySrc::at) and witness (the instance's operand at
// instance * inst_stride); the instance is the slow part of grid.z, so a
// block generates the entries of one instance's A for that instance's
// vectors only.  Composes with the range mode: every instance takes the
// same rows.  A single CRS is a batch of one.
//
// One GEMM per block, with many right-hand sides:
//     t^T (64 r_eff x kappa) = S (64 r_eff x 64 n) . A^T (64 n x kappa),
// S the negacyclic circulants of the witness vectors stacked one above the
// other (the signed A operand of mma.sync.m16n8k32, as in
// mma_stream.cuh, which this kernel shares its pieces with) and A^T the
// CRS (the unsigned B operand, 8 CRS rows per n-tile).  A block holds
// row_tiles 8-row tiles of the CRS and rhs_group witness vectors; per
// chunk of LC ring elements it
//   1. stages the chunk of its witness vectors, centred, in shared memory
//      and builds their circulants there as signed 8-bit limbs (the 4
//      byte-shifted copies of mma_stream.cuh, all limbs of a value from
//      one add: step 3 below);
//   2. generates each CRS entry of its rows and the chunk exactly once
//      (Threefry, the Barrett reduction of threefry.cuh, unsigned limbs),
//      spread over all its threads, into shared memory as limb bytes
//      already in each lane's B-fragment order;
//   3. runs the products: each warp owns one (row tile, witness vector,
//      MT m-tiles of 16 output coefficients) and reads its B fragments
//      with one 8-byte load per limb.
// So each CRS entry serves every witness vector of its block: it is
// generated ceil(r_eff / rhs_group) times over the grid (2x at r = 16,
// 23x at r' = 180 at small q; 34x at r' = 135 at big q), where the
// CUDA-core kernel before generated it ceil(r_eff / 4) times and spent 64
// int32 (small q) or int64 (big q) multiply-adds per entry and vector.
// Shared memory and not registers for the entries: a warp that looped
// over its vectors with the entries in registers would need every
// vector's accumulators (48 int32 at small q, 144 at big q per vector) or
// the chunk's entries (EL words per 4 entries) held at once; with the
// entries in shared memory a warp holds the sums of MT m-tiles of one
// vector only.  With one witness vector (r_eff = 1: check 15 and the
// fold, 3 of the 5 launches of a 2^14 -R run) the block's other warps take
// other ring elements of the chunk (l_groups) and their sums meet in
// shared memory, so no warp idles on a missing vector; a short stream
// takes fewer row tiles per block (ops/ajtai_cuda.py launch_shape).
//
// Limbs and exactness (ops/ajtai_cuda.py names the counts;
// tests/test_torch_tc_kernels.py models them against the plain version):
//   * small q (q <= 32513): entries 2 unsigned limbs of the residue, the
//     centred witness |x| <= q/2 <= 16,256 2 signed limbs (they hold
//     32,639): 4 limb pairs over 3 weights, MT = 4 (a warp's 4 m-tiles of
//     one vector: 48 int32 sums);
//   * big q (2^32 < q < 2^33): entries 5 unsigned limbs (four bytes and
//     the top bit), the centred witness |x| <= q/2 <= 2^32 - 5 5 signed
//     limbs: four hold only 127 (2^32 - 1) / 255 = 2,139,062,143, below
//     q/2 = 2,147,483,655 at q = 4294967311 (the wrapper's range check
//     admits [-q/2, q)).  25 limb pairs over 9 weights; MT = 1 (36 int32
//     sums), four warps per vector and row tile, blocks of up to 16 warps
//     (4 vectors) within 128 registers a thread.
//   * Each mma adds 32 products of magnitude <= 255 * 128 = 32640 to a
//     sum, and a weight takes at most min(EL, DL) <= 5 limb pairs, so a
//     ring element (2 halves) adds at most 2 * 5 * 32 * 32640 to it; a
//     flush every AJ_FLUSH_L = 128 ring elements that a warp adds keeps it
//     below 2^31 (static_assert below).  The flush adds sum_w 2^(8w) S_w
//     exactly, in int64 at small q (mma_flush) and mod q in __int128 at
//     big q (BigFlush: its constants once per thread, Barrett reductions
//     in place of the software 64-bit divisions of mma_flush).
// What bounds it on the H100: at the folded shapes the limb products on
// the tensor cores (25 pairs at big q) and the circulant and entry
// generation on the CUDA cores; global traffic is the witness and t.
// Shape limits (checked by the wrapper, labrador_tpu_torch/ops/ajtai_cuda.py):
// d = 64, q <= 32513 or 2^32 < q < 2^33 (a witness of residues or signed
// values in [-q/2, q)), instances * r_eff and n * 64 below 2^31, instances x
// rhs groups at most 65535 (grid.z); part and out indexed in 64 bits.
#include "mma_stream.cuh"

namespace {

constexpr int AJ_FLUSH_L = 128;
static_assert(AJ_FLUSH_L * 2 * 5 * 32 * 32640LL <= 2147483647LL,
              "int32 limb sums may overflow between flushes");

// The two modes: entry limbs, witness limbs, m-tiles per warp, ring
// elements per chunk, warps per block at most, blocks per SM the register
// budget is set for (both give 16 warps per SM at most 128 registers
// each), the staged witness and the running residue types.
template <bool BIG> struct AjtaiMode {
  static constexpr int EL = 2, DL = 2, MT = 4, LC = 8, WARPS = 8,
                       MIN_BLOCKS = 2;
  using Dig = int32_t;
  using Res = int32_t;    // in (-q, q), q < 2^15
};
template <> struct AjtaiMode<true> {
  static constexpr int EL = 5, DL = 5, MT = 1, LC = 4, WARPS = 16,
                       MIN_BLOCKS = 1;
  using Dig = int64_t;
  using Res = int64_t;
};

// The flush's constants at big q, once per thread: cw[w] = 2^(8w) mod q
// and c64 = 2^64 mod q, by barrett_mod (threefry.cuh) with m = barrett_m.
template <int NW>
struct BigFlush {
  uint64_t cw[NW];
  uint64_t c64;
  __device__ BigFlush(uint64_t q, uint64_t m) {
    cw[0] = 1;
#pragma unroll
    for (int w = 1; w < NW; ++w) cw[w] = barrett_mod(cw[w - 1] << 8, q, m);
    const uint64_t r = barrett_mod(~uint64_t{0}, q, m);  // (2^64 - 1) mod q
    c64 = r + 1 == q ? 0 : r + 1;
  }

  // res += sum_w 2^(8w) acc[w] mod q, in [0, q); acc = 0.  With res < q,
  // |acc[w]| < 2^31 and cw[w] < 2^33, |v| < 2^33 + NW 2^64 (NW = 9), so
  // v = hi 2^64 + lo with |hi| <= 9; hi c64 + (lo mod q) lies in
  // (-2^37, 2^37 + 2^33) and adding 32 q > 2^37 makes it a nonnegative
  // word for a second barrett_mod.
  template <int MT>
  __device__ void operator()(int32_t (&acc)[NW][MT][4],
                             int64_t (&res)[MT][4], uint64_t q,
                             uint64_t m) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        __int128 v = res[mt][c];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          v += static_cast<__int128>(cw[w]) * acc[w][mt][c];
          acc[w][mt][c] = 0;
        }
        const int64_t hi = static_cast<int64_t>(v >> 64);
        const int64_t t = hi * static_cast<int64_t>(c64) +
                          static_cast<int64_t>(barrett_mod(
                              static_cast<uint64_t>(v), q, m)) +
                          32 * static_cast<int64_t>(q);
        res[mt][c] = static_cast<int64_t>(
            barrett_mod(static_cast<uint64_t>(t), q, m));
      }
    }
  }
};

// The int32 sums' flush: mma_flush at small q, BigFlush at big q.
template <bool BIG, int EL, int NW, int MT, class R>
__device__ __forceinline__ void ajtai_flush(int32_t (&acc)[NW][MT][4],
                                            R (&res)[MT][4], int64_t q,
                                            const BigFlush<NW>& big,
                                            uint64_t m) {
  if constexpr (BIG) {
    big(acc, res, static_cast<uint64_t>(q), m);
  } else {
    mma_flush<EL, NW, MT, R>(acc, res, q);
  }
}

// Dynamic shared memory of a block: the chunk's buffers, then (l_groups >
// 1) the l-groups' sums of the block's rows.
template <bool BIG>
struct AjtaiSmem {
  using M = AjtaiMode<BIG>;
  typename M::Dig* dsh;   // [G][LC][D] centred witness
  uint32_t* circ;         // [G][LC][DL][4][MMA_COPY_WORDS]
  uint2* ent;             // [R_T][LC][2 halves][EL][32 lanes]
  unsigned long long* red;  // [R_T * 8][G][D], over the buffers above

  __device__ AjtaiSmem(unsigned char* base, int G, int R_T) {
    dsh = reinterpret_cast<typename M::Dig*>(base);
    circ = reinterpret_cast<uint32_t*>(dsh + G * M::LC * D);
    ent = reinterpret_cast<uint2*>(circ + G * M::LC * M::DL * 4 *
                                              MMA_COPY_WORDS);
    red = reinterpret_cast<unsigned long long*>(base);
  }

  static size_t bytes(int G, int R_T, int LG) {
    const size_t chunk = static_cast<size_t>(G) * M::LC * D *
                             sizeof(typename M::Dig) +
                         static_cast<size_t>(G) * M::LC * M::DL * 4 *
                             MMA_COPY_WORDS * sizeof(uint32_t) +
                         static_cast<size_t>(R_T) * M::LC * 2 * M::EL * 32 *
                             sizeof(uint2);
    const size_t reduce = LG > 1 ? static_cast<size_t>(R_T) * 8 * G * D *
                                       sizeof(unsigned long long)
                                 : 0;
    return chunk > reduce ? chunk : reduce;
  }
};

// part[s][b][j][row][k] = (sum over split s of A_b[row0 + row][l] (*)
// s_b[j][l])[k] mod q, row < rows, for instance b < instances.  s_b: the
// (nrhs, L, D) operand at dig + b * inst_stride, residues in [0, q) or
// signed values of magnitude at most q/2 (centred alike); grid (splits,
// row blocks, instances x rhs groups); a block of R_T * G * (4 / MT) * LG
// warps.  src_all.at(b)(offset) is instance b's CRS entry there
// (ThreefrySrc or TableSrc).
template <bool BIG, class Src>
__global__ void __launch_bounds__(AjtaiMode<BIG>::WARPS * 32,
                                  AjtaiMode<BIG>::MIN_BLOCKS)
ajtai_mma_kernel(const int64_t* __restrict__ dig, int64_t* __restrict__ part,
                 int nrhs, int L, int rows, int row0, int64_t q,
                 uint64_t barrett_m, Src src_all, int instances,
                 int64_t inst_stride, int R_T, int G, int LG,
                 int l_per_split) {
  using M = AjtaiMode<BIG>;
  constexpr int EL = M::EL, DL = M::DL, MT = M::MT, LC = M::LC;
  constexpr int MS = 4 / MT;             // warps per (row tile, vector)
  constexpr int NW = EL + DL - 1;        // limb weights
  extern __shared__ uint4 dyn_smem[];
  AjtaiSmem<BIG> sh(reinterpret_cast<unsigned char*>(dyn_smem), G, R_T);
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ms = warp % MS;
  const int rt = (warp / MS) % R_T;
  const int gj = (warp / (MS * R_T)) % G;
  const int lg = warp / (MS * R_T * G);
  const int n_groups = (nrhs + G - 1) / G;
  const int inst = blockIdx.z / n_groups;            // this block's instance
  const int grp = blockIdx.z - inst * n_groups;      // its rhs group
  const Src src = src_all.at(inst);
  dig += inst * inst_stride;
  // part rows of this instance's vectors: instance-major over all vectors
  const int64_t vec0 = static_cast<int64_t>(inst) * nrhs;
  const int64_t nvec = static_cast<int64_t>(instances) * nrhs;
  const int j = grp * G + gj;            // this warp's witness vector
  const bool j_ok = j < nrhs;
  const int row_base = blockIdx.y * R_T * 8;
  const int s = blockIdx.x;
  const int l_begin = s * l_per_split;
  const int l_end = min(L, l_begin + l_per_split);
  const int64_t half_q = q / 2;
  const uint64_t uq = static_cast<uint64_t>(q);
  const uint64_t row_stride = static_cast<uint64_t>(L) * D;
  int32_t acc[NW][MT][4];
  typename M::Res res[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      res[mt][c] = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w][mt][c] = 0;
    }
  }

  const BigFlush<NW> big_flush(uq, barrett_m);
  int since_flush = 0;
  for (int l0 = l_begin; l0 < l_end; l0 += LC) {
    const int nl = min(LC, l_end - l0);
    // 1. the chunk of the block's witness vectors, centred
#pragma unroll 4
    for (int e = threadIdx.x; e < G * LC * D; e += nthreads) {
      const int gg = e / (LC * D), l = (e / D) % LC, c = e % D;
      const int jj = grp * G + gg;
      typename M::Dig v = 0;
      if (l < nl && jj < nrhs) {
        const int64_t x = dig[(static_cast<int64_t>(jj) * L + l0 + l) * D + c];
        v = static_cast<typename M::Dig>(x > half_q ? x - q : x);
      }
      sh.dsh[e] = v;
    }
    // 2. the CRS entries of the block's rows, each once, as B fragments:
    // task (tile, l, half h, register r, lane) is the 4 entries of that
    // lane's register b_r, tile row g, coefficients 32 h + 16 r + 4 t ..
    // + 3 (mma_stream.cuh's layout); half a fragment a task, so that a
    // short chunk still gives every thread a task
    for (int task = threadIdx.x; task < R_T * LC * 128; task += nthreads) {
      const int tl = task & 31, r = (task >> 5) & 1, h = (task >> 6) & 1;
      const int l = (task >> 7) % LC, tile = (task >> 7) / LC;
      if (l >= nl) continue;
      const int row = row_base + tile * 8 + (tl >> 2);
      const uint64_t base = static_cast<uint64_t>(row0 + row) * row_stride +
                            static_cast<uint64_t>(l0 + l) * D +
                            32 * h + 16 * r + 4 * (tl & 3);
      uint64_t e4[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        e4[jj] = row < rows ? src(base + jj) : 0;
      }
      uint32_t limb[EL];
      pack_entry_limbs<EL>(e4, limb);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
                          sh.ent + (((tile * LC + l) * 2 + h) * EL) * 32 +
                          tl) + r;
#pragma unroll
      for (int ea = 0; ea < EL; ++ea) dst[ea * 64] = limb[ea];
    }
    __syncthreads();
    // 3. circ[gg][l][b][sh][w]: limb b of rext[4w + sh + jj] in byte jj,
    // rext[p] = p < 64 ? x[63 - p] : -x[127 - p] (0 beyond).  One task
    // builds the 4 shifted words of each limb from rext[4w .. 4w + 6].
    // The balanced limbs of v (each in [-128, 127]) are the bytes of
    // u = v + 128 (256^DL - 1) / 255, each less 128, i.e. XOR 0x80: one
    // add per value for all its limbs (|v| <= q/2 is within the limbs'
    // cover, so 0 <= u < 256^DL).
    for (int e = threadIdx.x; e < G * LC * 32; e += nthreads) {
      const int w = e & 31, gl = e >> 5;
      const typename M::Dig* x = sh.dsh + gl * D;
      constexpr uint64_t bias = 128 * (((uint64_t{1} << (8 * DL)) - 1) / 255);
      uint64_t u[7];
#pragma unroll
      for (int jj = 0; jj < 7; ++jj) {
        const int p = 4 * w + jj;
        int64_t v = 0;
        if (p < 64) {
          v = x[63 - p];
        } else if (p < 128) {
          v = -static_cast<int64_t>(x[127 - p]);
        }
        u[jj] = static_cast<uint64_t>(v) + bias;
      }
      uint32_t* dst = sh.circ + gl * DL * 4 * MMA_COPY_WORDS + w;
#pragma unroll
      for (int shift = 0; shift < 4; ++shift) {
        const uint64_t four[4] = {u[shift], u[shift + 1], u[shift + 2],
                                  u[shift + 3]};
        uint32_t word[DL];
        pack_entry_limbs<DL>(four, word);
#pragma unroll
        for (int b = 0; b < DL; ++b)
          dst[(b * 4 + shift) * MMA_COPY_WORDS] = word[b] ^ 0x80808080u;
      }
    }
    __syncthreads();
    // 4. the products of this warp's row tile, vector and m-tiles
    if (j_ok) {
      for (int l = lg; l < nl; l += LG) {
        const uint32_t* cl = sh.circ + (gj * LC + l) * DL * 4 *
                                           MMA_COPY_WORDS;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2 bw[EL];
          const uint2* src = sh.ent + (((rt * LC + l) * 2 + h) * EL) * 32 +
                             lane;
#pragma unroll
          for (int ea = 0; ea < EL; ++ea) bw[ea] = src[ea * 32];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const int mt = ms * MT + mi;
#pragma unroll
            for (int b = 0; b < DL; ++b) {
              uint32_t al[4];
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                // A fragment: k = 16 mt + g (+8), i = 32 h + 4 t (+16)
                const int a = 63 - (16 * mt + g + 8 * (rr & 1)) +
                              (32 * h + 4 * tq + 16 * (rr >> 1));
                al[rr] = cl[(b * 4 + (a & 3)) * MMA_COPY_WORDS + (a >> 2)];
              }
#pragma unroll
              for (int ea = 0; ea < EL; ++ea)
                mma_s8u8(acc[ea + b][mi], al, bw[ea].x, bw[ea].y);
            }
          }
        }
        if (++since_flush == AJ_FLUSH_L) {
          ajtai_flush<BIG, EL>(acc, res, q, big_flush, barrett_m);
          since_flush = 0;
        }
      }
    }
    __syncthreads();
  }
  ajtai_flush<BIG, EL>(acc, res, q, big_flush, barrett_m);

  // c[0..3] of m-tile mt: coefficient 16 mt + g (+8 for c >= 2), CRS row
  // 2 t (+1 for odd c) of the tile
  if (LG == 1) {
    if (!j_ok) return;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = row_base + rt * 8 + 2 * tq + (c & 1);
        const int k = 16 * (ms * MT + mi) + g + 8 * (c >> 1);
        int64_t v = res[mi][c];
        if (v < 0) v += q;
        if (n < rows) {
          part[((s * nvec + vec0 + j) * rows + n) * D + k] = v;
        }
      }
    }
    return;
  }
  // several l-groups: their sums meet in shared memory (the chunk buffers
  // are free after the loop's last barrier); at most 8 terms below q
  const int block_rows = R_T * 8;
  for (int e = threadIdx.x; e < block_rows * G * D; e += nthreads)
    sh.red[e] = 0;
  __syncthreads();
  if (j_ok) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = rt * 8 + 2 * tq + (c & 1);
        const int k = 16 * (ms * MT + mi) + g + 8 * (c >> 1);
        int64_t v = res[mi][c];
        if (v < 0) v += q;
        atomicAdd(&sh.red[(n * G + gj) * D + k],
                  static_cast<unsigned long long>(v));
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < block_rows * G * D; e += nthreads) {
    const int n = row_base + e / (G * D);
    const int jj = grp * G + (e / D) % G;
    if (n < rows && jj < nrhs) {
      part[((s * nvec + vec0 + jj) * rows + n) * D + e % D] =
          static_cast<int64_t>(sh.red[e] % uq);
    }
  }
}

template <bool BIG, class Src>
cudaError_t launch_ajtai(const int64_t* dig, int64_t* part, int nrhs, int L,
                         int rows, int row0, int64_t q, uint64_t barrett_m,
                         Src src, int instances, int64_t inst_stride,
                         int R_T, int G, int LG, int splits,
                         int l_per_split, cudaStream_t st) {
  using M = AjtaiMode<BIG>;
  const int warps = R_T * G * (4 / M::MT) * LG;
  const int64_t z_blocks = static_cast<int64_t>(instances) *
                           ((nrhs + G - 1) / G);
  if (R_T < 1 || G < 1 || LG < 1 || warps > M::WARPS || splits < 1 ||
      l_per_split % M::LC != 0 || instances < 1 || z_blocks > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = AjtaiSmem<BIG>::bytes(G, R_T, LG);
  static size_t smem_set = 0;      // the attribute, raised when needed
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ajtai_mma_kernel<BIG, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid(splits, (rows + 8 * R_T - 1) / (8 * R_T),
                  static_cast<unsigned>(z_blocks));
  ajtai_mma_kernel<BIG, Src><<<grid, 32 * warps, smem, st>>>(
      dig, part, nrhs, L, rows, row0, q, barrett_m, src, instances,
      inst_stride, R_T, G, LG, l_per_split);
  return cudaGetLastError();
}

// The split reduction into out (instances, r_eff, kappa, D) after the
// kernel's launch, or the launch's error.
cudaError_t reduce_ajtai(cudaError_t err, const int64_t* part, int64_t* out,
                         int64_t vectors, int kappa, int splits, int64_t q,
                         cudaStream_t st) {
  if (err != cudaSuccess) return err;
  const int64_t total = vectors * kappa * D;
  reduce_splits_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                         st>>>(part, out, splits, total, q);
  return cudaGetLastError();
}

}  // namespace

// The kernel in the mode of q, then the split reduction into out
// (instances, r_eff, kappa, D): the rows row0 .. row0 + kappa - 1 of A
// (kappa the rows of this call, all of A's at row0 = 0) for each of the
// `instances` instances, instance b with the CRS key keys[b] ((instances,
// 2) uint32 words in int64, on the device) and the witness at s + b *
// inst_stride.  Returns the first launch error, or cudaErrorInvalidValue
// for a launch shape the kernel does not take (the wrapper's launch_shape
// gives one it takes).
extern "C" int ajtai_commit_launch(const int64_t* s, int64_t* part,
                                   int64_t* out, int r_eff, int n, int kappa,
                                   int row0, int64_t q, uint64_t barrett_m,
                                   const int64_t* keys, int instances,
                                   int64_t inst_stride, int row_tiles,
                                   int rhs_group, int l_groups, int splits,
                                   int l_per_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ThreefrySrc src{keys, static_cast<uint64_t>(q), barrett_m};
  const cudaError_t err =
      q <= SMALL_Q_MAX
          ? launch_ajtai<false>(s, part, r_eff, n, kappa, row0, q, barrett_m,
                                src, instances, inst_stride, row_tiles,
                                rhs_group, l_groups, splits, l_per_split, st)
          : launch_ajtai<true>(s, part, r_eff, n, kappa, row0, q, barrett_m,
                               src, instances, inst_stride, row_tiles,
                               rhs_group, l_groups, splits, l_per_split, st);
  return static_cast<int>(reduce_ajtai(
      err, part, out, static_cast<int64_t>(instances) * r_eff, kappa, splits,
      q, st));
}

// The table mode: A's entries read from the table coeffs[0 .. total) of a
// crs.MaterializedCRS.  Small q only (cudaErrorInvalidValue above it).
extern "C" int ajtai_commit_table_launch(const int64_t* s, int64_t* part,
                                         int64_t* out, int r_eff, int n,
                                         int kappa, int row0, int64_t q,
                                         const int32_t* coeffs,
                                         uint64_t total, int row_tiles,
                                         int rhs_group, int l_groups,
                                         int splits, int l_per_split,
                                         void* stream) {
  if (q > SMALL_Q_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // barrett_m 0: only the big-q flush reads it
  const cudaError_t err = launch_ajtai<false>(
      s, part, r_eff, n, kappa, row0, q, 0, TableSrc{coeffs, total}, 1, 0,
      row_tiles, rhs_group, l_groups, splits, l_per_split, st);
  return static_cast<int>(reduce_ajtai(err, part, out, r_eff, kappa, splits,
                                       q, st));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

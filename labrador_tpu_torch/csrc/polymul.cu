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
//   domain.  An exact schoolbook: 4,096 multiply-adds a product against
//   1,536 bytes (a and b in, out back, int64), the same residue as the CRT
//   route (transform per prime, pointwise product, inverse, Garner) at
//   about a twelfth of its multiply-adds.  What bounds it on the H100: the
//   bytes (0.0459 ms for 10^5 products at 3.35 TB/s) once each
//   multiply-add is one IMAD (0.0245 ms at 64 IMADs a clock and SM); no
//   operand is shared across products, so the tensor cores have nothing
//   to amortise.  Design (polymul_coef_kernel):
//   * the operands are centred residues, |x| <= h = floor(q / 2): a value
//     in [-q, q) takes one conditional add, any other int64 the 64-bit
//     Barrett reduction of res_mod; no 64-bit `%` or division anywhere;
//   * int32 accumulators, one IMAD a multiply-add: a product is at most
//     h^2, so F terms sum exactly in int32 for F h^2 < 2^31.  The wrapper
//     picks the flush length F in {64, 32, 16, 8} per q (64 for q <=
//     11585, so q = 8191 never flushes; 8 at P_MAX = 32513), checked by
//     the launcher below; at each flush x = sum + S (S a multiple of q
//     above F h^2, 2 F h^2 + q <= 2^32) goes through barrett32;
//   * register tiling: 8 threads a product, 8 consecutive outputs a
//     thread.  The negacyclic sign is folded into a doubled copy of b,
//     ext[m] = m >= 64 ? b[m-64] : -b[m], so (a (*) b)[k] = sum_i a[i]
//     ext[k - i + 64]; the thread's window of ext slides down by one a
//     step and stays in registers through the unrolled loop, refilled by
//     one 16-byte load of 8 int16 residues every 8 steps; a arrives as
//     16-byte broadcast loads of int32 residues.  Each shared load feeds
//     32 or more IMADs;
//   * a persistent grid, two blocks an SM, walks tiles of 32 products: the
//     next tile's raw int64 rows (32 KB) come in by cp.async, 16 bytes a
//     thread and 512 bytes a warp instruction, while the current tile is
//     reduced and multiplied; each warp passes its outputs through shared
//     memory so that every 16-byte store instruction writes one product's
//     512 contiguous bytes;
//   * broadcast by strides: row r = ro n_inner + ri of the output reads
//     each operand's row at ro outer + ri inner (either stride 0 for a
//     fixed operand), so the main path's broadcasts are never copied.
//   Measured on an H100 80GB HBM3 at 700 W (kernel_times.py, PERF.md
//   section 6): 0.0607 ms for 10^5 products, 76% of the byte bound and 88%
//   of what one torch.add moving the same bytes takes (0.0535 ms), from
//   0.1419-0.1425 ms; 64 registers, no spills.
//
// polymul_bhat   out[n] = INTT(NTT(a[n]) .* bhat[:, n]) folded mod q, the
//   second operand given in the evaluation domain, per CRT prime (the
//   serving shape of one operand fixed across many products).  It must go
//   through the CRT: per prime p, the forward transform x = (a mod p) @ V_p
//   mod p, the pointwise product with bhat mod p, the inverse transform
//   @ W_p mod p; then Garner's mixed-radix digits and the signed fold mod q
//   exactly as ops/zq.fold_res_modq computes them (digit chain, comparison
//   with floor(M/2), final mod q).  Design for Hopper (polymul_bhat_kernel):
//   * both transforms are GEMMs on int8 tensor cores, mma.sync.m16n8k32
//     with unsigned 8-bit limbs on both sides: a value below 2^16 is
//     lo + 2^8 hi, so each transform is 4 limb products over 3 weights,
//     S0 = lo.lo, S1 = lo.hi + hi.lo, S2 = hi.hi, each an exact int32 sum
//     of 64 terms (bounds at weights_mod).  int8 and not FP64
//     mma: the FP64 tensor rate is 1/30 of the int8 rate, and at P = 3
//     primes the FP64 products alone would take longer than the bytes;
//   * a warp owns a tile of 16 rows of a (the M dimension); V_p and W_p are
//     the 64 x 64 B operand, held in shared memory as limb bytes already
//     packed in each lane's B-fragment order (2 x P x 8 KB, built by the
//     wrapper), so a lane reads its fragment words with one 8-byte load;
//   * the K order of both GEMMs is permuted (the tables' rows with it) so
//     that a lane's A fragment holds exactly the columns that its C
//     fragment holds (columns 8j + 2t, 8j + 2t + 1): the pointwise product
//     y = xhat .* bhat goes from the first GEMM's accumulators straight
//     into the second GEMM's A registers, with no shared-memory round trip;
//   * every reduction mod p, Garner's and the fold's mod q use a 32-bit
//     Barrett reduction with constants from the wrapper (barrett32, bound
//     proved there); no runtime `%`.  Where the next step's bound allows
//     it a value stays in [0, 2p) (barrett32_lazy: 2p < 2^16 still fits
//     two unsigned limbs), which saves the conditional subtraction;
//   * with one operand for every row (row stride 0: the serving shape),
//     each block folds it into its copy of the inverse table, W'_p =
//     diag(bhat_p) W_p mod p, so the pointwise product costs nothing per
//     row; a per-row operand is multiplied in the first GEMM's epilogue;
//   * a is read once, coalesced (512 B per row and warp instruction), and
//     its residues per prime go to the warp's shared tile as 16-bit values;
//     the second GEMM's residues replace them there, and the Garner pass
//     reads them per row and writes out once, coalesced;
//   * one instantiation per prime count P, so that the loops over the
//     primes of the load and of Garner unroll.
//   What bounds it on the H100: not the bytes (a in, out back, 1 KB per
//   product), but the integer work on the CUDA cores around the tensor-core
//   products: per product and prime about 2 x 10 int32 operations of
//   reduction, and per product about 40 for Garner and the fold (PERF.md:
//   with no read of a at all it still takes two thirds of its time).
//
// Shapes (checked by ops/polymul_cuda.py): rows of 64 int64 coefficients,
// n rows; the bhat variant reads an operand that broadcasts one row over
// all n with row stride 0, else 64.  bhat is (P, n or 1, 64), 1 <= P <= 6
// (one instantiation each; another P returns cudaErrorInvalidValue).  Any
// int64 operand is reduced exactly (a 64-bit Barrett path for values
// outside [-p, p)).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;
constexpr int BHAT_WARPS = 8;                    // warps per block
constexpr int BHAT_THREADS = BHAT_WARPS * 32;
constexpr int BHAT_TILE = 16;                    // rows of a per warp tile
constexpr int BUF_STRIDE = 72;                   // u16 per tile row: 64 + 8
// uint2 fragment words per transform and prime: k-step, n-tile, limb, lane
constexpr int TABLE_WORDS = 2 * 8 * 2 * 32;

// x mod p for x < 2^32 and p < 2^31, with m = floor(2^32 / p) from the
// wrapper (ops/polymul_cuda.py bhat_consts): with 2^32 = m p + rho,
// 0 < rho < p, x m / 2^32 = x / p - x rho / (p 2^32) and x < 2^32 makes
// the second term below 1, so t = floor(x m / 2^32) is floor(x / p) or one
// less; r = x - t p is in [0, 2p) (exact in wrapping 32-bit arithmetic).
// barrett32_lazy stops there, a representative in [0, 2p) where the next
// step's bound allows it; barrett32 subtracts p once more.
__device__ __forceinline__ uint32_t barrett32_lazy(uint32_t x, uint32_t p,
                                                   uint32_t m) {
  return x - __umulhi(x, m) * p;
}

__device__ __forceinline__ uint32_t barrett32(uint32_t x, uint32_t p,
                                              uint32_t m) {
  const uint32_t r = barrett32_lazy(x, p, m);
  return r >= p ? r - p : r;
}

// x mod p in [0, p) for any int64 x: directly for x in [-p, p), else by
// the 64-bit Barrett reduction of |x| (csrc/threefry.cuh barrett_mod's
// bound, m64 = floor((2^64 - 1) / p)) and the sign.
__device__ __forceinline__ uint32_t res_mod(int64_t x, uint32_t p,
                                            uint64_t m64) {
  if (x >= -static_cast<int64_t>(p) && x < static_cast<int64_t>(p))
    return static_cast<uint32_t>(x < 0 ? x + p : x);
  const uint64_t u = x < 0 ? 0 - static_cast<uint64_t>(x)
                           : static_cast<uint64_t>(x);
  uint64_t r = u - __umul64hi(u, m64) * p;
  if (r >= p) r -= p;
  return static_cast<uint32_t>(x < 0 && r ? p - r : r);
}

// ---------------------------------------------------------------------------
// polymul_coef: the exact schoolbook on the CUDA cores (design at the top).
// ---------------------------------------------------------------------------

constexpr int COEF_TILE = 32;                    // products per block step
constexpr int COEF_THREADS = 256;                // 8 a product, 8 outputs each
constexpr int COEF_STAGES = 2;                   // raw tiles in flight
constexpr int COEF_A_STRIDE = D + 4;             // int32 per row of a
constexpr int COEF_EXT = 2 * D;                  // int16 per row of ext
constexpr size_t COEF_SMEM =
    COEF_STAGES * 2 * COEF_TILE * D * sizeof(int64_t) +
    COEF_TILE * COEF_A_STRIDE * sizeof(int32_t) +
    COEF_TILE * COEF_EXT * sizeof(int16_t);
static_assert(COEF_THREADS == COEF_TILE * 8, "8 threads a product");
// at P_MAX = 32513, h = 16256: 8 terms of h^2 sum in int32, 9 do not
static_assert(8LL * 16256 * 16256 < (1LL << 31) &&
                  9LL * 16256 * 16256 >= (1LL << 31),
              "the flush length 8 at P_MAX");

// Row addressing of the flattened broadcast: row r = ro n_inner + ri of
// the output reads an operand's row at base + ro outer + ri inner.
struct CoefArgs {
  int64_t n, n_inner;
  int64_t a_outer, a_inner, b_outer, b_inner;
  uint32_t q, m32, shift;                        // barrett32's m, S
  int32_t h;                                     // floor(q / 2)
  uint64_t m64;                                  // floor((2^64 - 1) / q)
};

// 16 bytes global -> shared, asynchronously; zeros where !valid (nothing
// is read then).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The raw rows of a and b of one tile into raw[2][COEF_TILE][D]: warp w
// of W copies rows w, w + W, .., 512 bytes of one row an instruction.
__device__ __forceinline__ void coef_issue(int64_t* raw,
                                           const int64_t* __restrict__ a,
                                           const int64_t* __restrict__ b,
                                           int64_t tile, const CoefArgs& g) {
  constexpr int W = COEF_THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < COEF_TILE / W; ++s) {
    const int rr = warp + W * s;
    const int64_t row = tile * COEF_TILE + rr;
    const bool valid = row < g.n;
    // n < 2^31 (the launcher's check): 32-bit division, only where the
    // broadcast has an outer dimension
    uint32_t ro = 0, ri = static_cast<uint32_t>(row);
    if (g.n_inner < g.n && valid) {
      ro = static_cast<uint32_t>(row) / static_cast<uint32_t>(g.n_inner);
      ri = static_cast<uint32_t>(row) - ro * static_cast<uint32_t>(g.n_inner);
    }
    const int64_t* ga = a + ro * g.a_outer + ri * g.a_inner + 2 * lane;
    const int64_t* gb = b + ro * g.b_outer + ri * g.b_inner + 2 * lane;
    cp_async16(raw + rr * D + 2 * lane, valid ? ga : a, valid);
    cp_async16(raw + (COEF_TILE + rr) * D + 2 * lane, valid ? gb : b, valid);
  }
}

// x as its centred residue mod q, in [-h, h]: directly for x in [-q, q),
// else by res_mod's 64-bit Barrett reduction; then one conditional add or
// subtraction of q.
__device__ __forceinline__ int32_t coef_centred(int64_t x, const CoefArgs& g) {
  const int32_t q = static_cast<int32_t>(g.q);
  const int32_t r =
      static_cast<uint64_t>(x) + g.q < 2ull * g.q
          ? static_cast<int32_t>(x)
          : static_cast<int32_t>(res_mod(x, g.q, g.m64));
  return r > g.h ? r - q : (r < -g.h ? r + q : r);
}

__device__ __forceinline__ uint32_t pack16(int32_t lo, int32_t hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) | static_cast<uint32_t>(hi)
                                                     << 16;
}

// The raw tile as centred residues: a to a_c (int32), b to ext (int16,
// ext[m] = b[m - 64] for m >= 64, -b[m] below).  Pairs c = tid + 256 s:
// row c / 32, columns 2 (c % 32) and the next, 16 bytes a thread.
__device__ __forceinline__ void coef_convert(const int64_t* raw,
                                             int32_t* a_c, int16_t* ext,
                                             const CoefArgs& g) {
#pragma unroll
  for (int s = 0; s < COEF_TILE * D / 2 / COEF_THREADS; ++s) {
    const int c = threadIdx.x + COEF_THREADS * s;
    const int rr = c >> 5, e = 2 * (c & 31);
    const longlong2 va = *reinterpret_cast<const longlong2*>(raw + rr * D + e);
    const longlong2 vb =
        *reinterpret_cast<const longlong2*>(raw + (COEF_TILE + rr) * D + e);
    const int32_t b0 = coef_centred(vb.x, g), b1 = coef_centred(vb.y, g);
    *reinterpret_cast<int2*>(a_c + rr * COEF_A_STRIDE + e) =
        make_int2(coef_centred(va.x, g), coef_centred(va.y, g));
    *reinterpret_cast<uint32_t*>(ext + rr * COEF_EXT + D + e) = pack16(b0, b1);
    *reinterpret_cast<uint32_t*>(ext + rr * COEF_EXT + e) = pack16(-b0, -b1);
  }
}

// 8 int16 residues (one 16-byte word) as int32.
__device__ __forceinline__ void unpack8(uint4 w, int32_t* v) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = static_cast<int16_t>(x[k] & 0xFFFFu);
    v[2 * k + 1] = static_cast<int32_t>(x[k]) >> 16;
  }
}

// Outputs 8t .. 8t + 7 of the product in row pr of the tile, in [0, q).
// At step i = 8j + s the thread needs ext[8t + 64 - i + r], r < 8: buf[8 -
// s + r] with buf[0..7] ext's group t + 7 - j and buf[8..15] group t + 8 -
// j (each group 8 aligned int16, one 16-byte load).  Every F steps the
// int32 sums (|sum| <= F h^2 < 2^31) are shifted by S and reduced.
template <int F>
__device__ __forceinline__ void coef_product(const int32_t* a_c,
                                             const int16_t* ext, int pr,
                                             int t, const CoefArgs& g,
                                             uint32_t (&res)[8]) {
  const int32_t* ap = a_c + pr * COEF_A_STRIDE;
  const uint4* ep = reinterpret_cast<const uint4*>(ext + pr * COEF_EXT);
  int32_t buf[16], acc[8];
  uint32_t tot[8];
  unpack8(ep[t + 8], buf + 8);
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0, tot[r] = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unpack8(ep[t + 7 - j], buf);
    const int4 a0 = *reinterpret_cast<const int4*>(ap + 8 * j);
    const int4 a1 = *reinterpret_cast<const int4*>(ap + 8 * j + 4);
    const int32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] += av[s] * buf[8 - s + r];
      if (F < D && (8 * j + s + 1) % F == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          tot[r] += barrett32_lazy(static_cast<uint32_t>(acc[r]) + g.shift,
                                   g.q, g.m32);
          acc[r] = 0;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[8 + r] = buf[r];
  }
  // F = 64: one shifted sum; else at most 8 lazy residues, below 16 q
#pragma unroll
  for (int r = 0; r < 8; ++r)
    res[r] = barrett32(F < D ? tot[r] : static_cast<uint32_t>(acc[r]) + g.shift,
                       g.q, g.m32);
}

// One persistent block walks tiles blockIdx.x, + gridDim.x, ..: the next
// tile's copies are issued before the current one is converted and
// multiplied (two raw stages; a_c and ext hold the current tile).
template <int F>
__global__ void __launch_bounds__(COEF_THREADS, 2)
polymul_coef_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ b, int64_t* __restrict__ out,
                    const CoefArgs g) {
  extern __shared__ uint4 dyn[];
  int64_t* raw = reinterpret_cast<int64_t*>(dyn);
  int32_t* a_c = reinterpret_cast<int32_t*>(raw + COEF_STAGES * 2 *
                                                      COEF_TILE * D);
  int16_t* ext = reinterpret_cast<int16_t*>(a_c + COEF_TILE * COEF_A_STRIDE);
  const int64_t tiles = (g.n + COEF_TILE - 1) / COEF_TILE;
  const int pr = threadIdx.x >> 3, t = threadIdx.x & 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int64_t tile = blockIdx.x;
  if (tile < tiles) coef_issue(raw, a, b, tile, g);
  cp_async_commit();
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles)
      coef_issue(raw + ((k + 1) % COEF_STAGES) * 2 * COEF_TILE * D, a, b,
                 next, g);
    cp_async_commit();
    cp_async_wait_prior();           // this thread's copies of this tile
    __syncthreads();                 // everyone's; the last tile's reads done
    coef_convert(raw + (k % COEF_STAGES) * 2 * COEF_TILE * D, a_c, ext, g);
    __syncthreads();
    uint32_t res[8];
    coef_product<F>(a_c, ext, pr, t, g, res);
    // the warp's 4 products through its own 4 rows of ext (no other warp
    // reads them), so that store r writes product 4 warp + r's 512
    // contiguous bytes
    __syncwarp();
    uint4* st = reinterpret_cast<uint4*>(ext + warp * 4 * COEF_EXT);
    st[2 * lane] = make_uint4(res[0], res[1], res[2], res[3]);
    st[2 * lane + 1] = make_uint4(res[4], res[5], res[6], res[7]);
    __syncwarp();
    const uint32_t* rs = reinterpret_cast<const uint32_t*>(st);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = tile * COEF_TILE + 4 * warp + r;
      const uint2 v = *reinterpret_cast<const uint2*>(rs + 64 * r + 2 * lane);
      if (row < g.n)
        *reinterpret_cast<longlong2*>(out + row * D + 2 * lane) =
            make_longlong2(v.x, v.y);
    }
  }
}

// (S0 + 2^8 S1 + 2^16 S2) mod p, in [0, 2p), for the int32 weight sums of
// one output of a transform over 64 terms.  The table's limbs are lo <=
// 255, hi <= 127 (residues below p < 2^15); the operand's lo, hi <= 255
// (values in [0, 2p), 2p < 2^16), so S0 <= 64 * 255^2 = 4,161,600, S1 <=
// 64 * (255 * 127 + 255 * 255) = 6,234,240, S2 <= 64 * 255 * 127 =
// 2,072,640, all >= 0 and below 2^31.  w = S1 + 2^8 S2 <= 536,830,080 and
// S0 + 2^8 (w mod p) < 4,161,600 + 2^8 * 2^16 are below 2^32, each reduced
// by barrett32_lazy.
__device__ __forceinline__ uint32_t weights_mod(const int32_t (&s)[3][4][4],
                                                int nt, int c, uint32_t p,
                                                uint32_t m) {
  const uint32_t w = barrett32_lazy(
      static_cast<uint32_t>(s[1][nt][c]) +
          (static_cast<uint32_t>(s[2][nt][c]) << 8),
      p, m);
  return barrett32_lazy(static_cast<uint32_t>(s[0][nt][c]) + (w << 8), p, m);
}

// One mma.sync.m16n8k32: c (16 x 8, int32) += a (16 x 32 unsigned bytes) .
// b (32 x 8 unsigned bytes).
__device__ __forceinline__ void mma_u8u8(int32_t (&c)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One transform of a warp's 16-row tile against table tab (the B
// fragments of T_p for this transform and prime): acc[w][nt] for the 4
// n-tiles 4 nh.. of output columns, a[s][limb] the A fragments of k-steps
// 0 and 1 (limb 0 the low bytes).  Weight w = limb of a + limb of T.
__device__ __forceinline__ void transform_half(int32_t (&acc)[3][4][4],
                                               const uint32_t (&a)[2][2][4],
                                               const uint2* tab, int nh,
                                               int lane) {
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][nt][c] = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint2* tb = tab + ((s * 8 + 4 * nh + nt) * 2) * 32;
      const uint2 b0 = tb[lane], b1 = tb[32 + lane];
      mma_u8u8(acc[0][nt], a[s][0], b0);
      mma_u8u8(acc[1][nt], a[s][0], b1);
      mma_u8u8(acc[1][nt], a[s][1], b0);
      mma_u8u8(acc[2][nt], a[s][1], b1);
    }
  }
}

// The K order of both transforms (the wrapper permutes the tables' rows
// alike): in k-step s, the bytes j = 2 pp + e of the A register 2 hp + rh
// of lane (g, t) are the columns 32 s + 16 hp + 8 pp + 2 t + e of row
// g + 8 rh: the columns that the lane's C fragments of n-tiles 4 s + 2 hp
// + pp hold.  From two words of 16-bit residues (columns 2t, 2t + 1 and
// 8 + 2t, 8 + 2t + 1), the low and the high limb bytes.
__device__ __forceinline__ void pack_limbs(uint32_t w0, uint32_t w1,
                                           uint32_t& lo, uint32_t& hi) {
  lo = __byte_perm(w0, w1, 0x6420);
  hi = __byte_perm(w0, w1, 0x7531);
}

// Columns 2 lane, 2 lane + 1 of a tile's 16 rows of a (zero past row n):
// 512 B per row and warp load, all 16 loads in flight before the first is
// used.
__device__ __forceinline__ void load_rows(longlong2 (&av)[BHAT_TILE],
                                          const int64_t* __restrict__ a,
                                          int64_t tile, int64_t n,
                                          int64_t a_stride, int lane) {
#pragma unroll
  for (int rr = 0; rr < BHAT_TILE; ++rr) {
    const int64_t row = tile * BHAT_TILE + rr;
    av[rr] = row < n ? *reinterpret_cast<const longlong2*>(
                           a + row * a_stride + 2 * lane)
                     : make_longlong2(0, 0);
  }
}

// consts: primes[P] | m32[P] (floor(2^32 / p)) | m64[P] (floor((2^64 -
// 1) / p)) | garner_inv[P][P] (inv(p_j) mod p_k at [j][k]) |
// m_half_digits[P] | prefix_mod_q[P] | m_mod_q | q | floor(2^32 / q).
// tables: uint2 words [2][P][TABLE_WORDS], transform (V then W), prime,
// then k-step, n-tile, limb, lane: the B fragments of V_p and W_p with
// their rows in the K order above (ops/polymul_cuda.py bhat_tables).
// One instantiation per prime count, so that every loop over the primes
// unrolls and the constants stay in registers.
template <int P>
__global__ void __launch_bounds__(BHAT_THREADS, 2)
polymul_bhat_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ bhat,
                    const uint2* __restrict__ tables,
                    const int64_t* __restrict__ consts,
                    int64_t* __restrict__ out, int64_t n, int64_t a_stride,
                    int64_t bhat_row_stride, int64_t bhat_prime_stride) {
  extern __shared__ uint4 dyn[];
  uint2* tab = reinterpret_cast<uint2*>(dyn);               // 2 P tables
  uint32_t* bh_sh = reinterpret_cast<uint32_t*>(tab + 2 * P * TABLE_WORDS);
  uint16_t* buf_all = reinterpret_cast<uint16_t*>(bh_sh + P * D);
#pragma unroll 8
  for (int i = threadIdx.x; i < 2 * P * TABLE_WORDS; i += BHAT_THREADS)
    tab[i] = tables[i];
  // the per-prime constants: in registers where the prime is known at
  // compile time, in shared memory for the (rolled) loop of the transforms
  __shared__ uint32_t pr_sh[P], m32_sh[P];
  __shared__ uint64_t m64_sh[P];
  uint32_t pr[P], m32[P];
  uint64_t m64[P];
  uint32_t pmin = 1u << 31;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    pr[i] = static_cast<uint32_t>(consts[i]);
    m32[i] = static_cast<uint32_t>(consts[P + i]);
    m64[i] = static_cast<uint64_t>(consts[2 * P + i]);
    pmin = min(pmin, pr[i]);
  }
  if (threadIdx.x < P) {
    pr_sh[threadIdx.x] = static_cast<uint32_t>(consts[threadIdx.x]);
    m32_sh[threadIdx.x] = static_cast<uint32_t>(consts[P + threadIdx.x]);
    m64_sh[threadIdx.x] = static_cast<uint64_t>(consts[2 * P + threadIdx.x]);
  }
  const bool fixed_b = bhat_row_stride == 0;
  if (fixed_b) {
    for (int i = threadIdx.x; i < P * D; i += BHAT_THREADS) {
      uint32_t v = 0;
#pragma unroll
      for (int pi = 0; pi < P; ++pi) {
        if (i / D == pi)
          v = res_mod(bhat[pi * bhat_prime_stride + i % D], pr[pi], m64[pi]);
      }
      bh_sh[i] = v;
    }
    __syncthreads();
    // one operand for every row: the pointwise product moves into the
    // inverse table, W'_p[k][n] = bhat_p[k] W_p[k][n] mod p (y W_p =
    // xhat W'_p for y = xhat .* bhat_p), each word's 4 entries of row
    // k = the column of byte j of B register bi (the K order above)
    for (int i = threadIdx.x; i < P * TABLE_WORDS; i += BHAT_THREADS) {
      const int pi = i / TABLE_WORDS, r = i % TABLE_WORDS;
      const int lane = r & 31, s = r >> 9;
      if (((r >> 5) & 1) != 0) continue;           // limb 1: with limb 0
      uint2* lo = tab + (P + pi) * TABLE_WORDS + r;
      uint2* hi = lo + 32;
      uint32_t p = 0, m = 0;
#pragma unroll
      for (int pj = 0; pj < P; ++pj) {
        if (pj == pi) {
          p = pr[pj];
          m = m32[pj];
        }
      }
      uint32_t wl[2] = {0, 0}, wh[2] = {0, 0};
#pragma unroll
      for (int bi = 0; bi < 2; ++bi) {
        const uint32_t l0 = bi ? lo->y : lo->x, h0 = bi ? hi->y : hi->x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 32 * s + 16 * bi + 8 * (j >> 1) + 2 * (lane & 3) +
                        (j & 1);
          const uint32_t e = ((l0 >> (8 * j)) & 255) |
                             ((h0 >> (8 * j)) & 255) << 8;
          const uint32_t v = barrett32(e * bh_sh[pi * D + k], p, m);
          wl[bi] |= (v & 255) << (8 * j);
          wh[bi] |= (v >> 8) << (8 * j);
        }
      }
      *lo = make_uint2(wl[0], wl[1]);
      *hi = make_uint2(wh[0], wh[1]);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* buf = buf_all + warp * P * BHAT_TILE * BUF_STRIDE;
  const int64_t tiles = (n + BHAT_TILE - 1) / BHAT_TILE;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * BHAT_WARPS + warp;
       tile < tiles; tile += static_cast<int64_t>(gridDim.x) * BHAT_WARPS) {
    const int64_t row0 = tile * BHAT_TILE;
    // a's residues per prime into the tile.  A coefficient in [0, min p)
    // is its own residue at every prime.
    longlong2 av[BHAT_TILE];
    load_rows(av, a, tile, n, a_stride, lane);
#pragma unroll
    for (int rr = 0; rr < BHAT_TILE; ++rr) {
      const longlong2 v = av[rr];
      const bool own = static_cast<uint64_t>(v.x) < pmin &&
                       static_cast<uint64_t>(v.y) < pmin;
      const uint32_t both = static_cast<uint32_t>(v.x) |
                            static_cast<uint32_t>(v.y) << 16;
#pragma unroll
      for (int pi = 0; pi < P; ++pi) {
        *reinterpret_cast<uint32_t*>(
            buf + (pi * BHAT_TILE + rr) * BUF_STRIDE + 2 * lane) =
            own ? both
                : res_mod(v.x, pr[pi], m64[pi]) |
                      res_mod(v.y, pr[pi], m64[pi]) << 16;
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int pi = 0; pi < P; ++pi) {
      const uint32_t p = pr_sh[pi], mp = m32_sh[pi];
      const uint64_t m64p = m64_sh[pi];
      uint16_t* bp = buf + pi * BHAT_TILE * BUF_STRIDE;
      const uint2* tv = tab + pi * TABLE_WORDS;
      const uint2* tw = tab + (P + pi) * TABLE_WORDS;
      uint32_t x[2][2][4];                       // [k-step][limb][register]
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int hp = 0; hp < 2; ++hp)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const uint16_t* r0 =
                bp + (g + 8 * rh) * BUF_STRIDE + 32 * s + 16 * hp + 2 * t;
            pack_limbs(*reinterpret_cast<const uint32_t*>(r0),
                       *reinterpret_cast<const uint32_t*>(r0 + 8),
                       x[s][0][2 * hp + rh], x[s][1][2 * hp + rh]);
          }
      // forward transform, pointwise product: y, the inverse's A operand
      uint32_t y[2][2][4];
      int32_t acc[3][4][4];
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        transform_half(acc, x, tv, nh, lane);
#pragma unroll
        for (int hp = 0; hp < 2; ++hp)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int64_t row = row0 + g + 8 * rh;
            uint32_t w[2];
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              const int nt = 2 * hp + pp;
              const int col = 8 * (4 * nh + nt) + 2 * t;
              // xhat in [0, 2p); with a fixed operand y = xhat (the
              // product is in W'), else y = xhat * bhat in [0, 2p): the
              // product is below 2p * p < 2^31
              uint32_t y0 = weights_mod(acc, nt, 2 * rh, p, mp);
              uint32_t y1 = weights_mod(acc, nt, 2 * rh + 1, p, mp);
              if (!fixed_b) {
                longlong2 bv = make_longlong2(0, 0);
                if (row < n)
                  bv = *reinterpret_cast<const longlong2*>(
                      bhat + pi * bhat_prime_stride + row * bhat_row_stride +
                      col);
                y0 = barrett32_lazy(y0 * res_mod(bv.x, p, m64p), p, mp);
                y1 = barrett32_lazy(y1 * res_mod(bv.y, p, m64p), p, mp);
              }
              w[pp] = y0 | y1 << 16;
            }
            pack_limbs(w[0], w[1], y[nh][0][2 * hp + rh],
                       y[nh][1][2 * hp + rh]);
          }
      }
      __syncwarp();                  // every lane has read its x from bp
      // inverse transform: its residues, in [0, 2p), replace a's in the
      // tile
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        transform_half(acc, y, tw, nh, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            *reinterpret_cast<uint32_t*>(
                bp + (g + 8 * rh) * BUF_STRIDE + 8 * (4 * nh + nt) + 2 * t) =
                weights_mod(acc, nt, 2 * rh, p, mp) |
                weights_mod(acc, nt, 2 * rh + 1, p, mp) << 16;
          }
      }
    }
    __syncwarp();
    // Garner's digits and the signed fold mod q, columns 2 lane, 2 lane + 1
    // of each row, from residues r_k in [0, 2 p_k).  v_0 = r_0 mod p_0,
    // v_k = ((r_k - v_0) inv(p_0) - v_1) inv(p_1) ... inv(p_{k-1}) mod p_k
    // (ops/zq.fold_res_modq's chain); each difference is taken as t +
    // 2 p_k - v_j in (0, 4 p_k) with t in [0, 2 p_k) (v_j < p_j < 2 p_k:
    // every prime lies in (2^14, 2^15), checked by the wrapper), so each
    // product with an inverse below p_k is below 4 p_k^2 < 2^32: lazy
    // Barrett steps, a full one for each digit.  The fold sums v_j prefix_j, each below
    // 2^15 q; for P * 2^15 * q < 2^32 (P <= 4 at q <= 32513) one barrett32
    // mod q at the end, else one after each term.
    {
      uint32_t gi[P * P], mh[P], pre[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        mh[i] = static_cast<uint32_t>(consts[3 * P + P * P + i]);
        pre[i] = static_cast<uint32_t>(consts[4 * P + P * P + i]);
#pragma unroll
        for (int k = 0; k < P; ++k)
          gi[i * P + k] = static_cast<uint32_t>(consts[3 * P + i * P + k]);
      }
      const uint32_t m_mod_q = static_cast<uint32_t>(consts[5 * P + P * P]);
      const uint32_t q = static_cast<uint32_t>(consts[5 * P + P * P + 1]);
      const uint32_t m32q = static_cast<uint32_t>(consts[5 * P + P * P + 2]);
      constexpr bool one_reduce = P * 32768LL * 32513LL < (1LL << 32);
      const int nrows = static_cast<int>(
          min(static_cast<int64_t>(BHAT_TILE), n - row0));
#pragma unroll 2
      for (int rr = 0; rr < nrows; ++rr) {
        uint32_t rw[P];
#pragma unroll
        for (int k = 0; k < P; ++k)
          rw[k] = *reinterpret_cast<const uint32_t*>(
              buf + (k * BHAT_TILE + rr) * BUF_STRIDE + 2 * lane);
        int64_t res2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t v[P];
          v[0] = e ? rw[0] >> 16 : rw[0] & 0xFFFF;
          if (v[0] >= pr[0]) v[0] -= pr[0];
#pragma unroll
          for (int k = 1; k < P; ++k) {
            const uint32_t rk = e ? rw[k] >> 16 : rw[k] & 0xFFFF;
            uint32_t tt = rk + 2 * pr[k] - v[0];
#pragma unroll
            for (int j = 1; j < k; ++j)
              tt = barrett32_lazy(tt * gi[(j - 1) * P + k], pr[k], m32[k]) +
                   2 * pr[k] - v[j];
            v[k] = barrett32(tt * gi[(k - 1) * P + k], pr[k], m32[k]);
          }
          uint32_t acc_q = 0;
          bool gt = false;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            acc_q += v[j] * pre[j];
            if (!one_reduce) acc_q = barrett32(acc_q, q, m32q);
            gt = (v[j] > mh[j]) || (v[j] == mh[j] && gt);
          }
          if (one_reduce) acc_q = barrett32(acc_q, q, m32q);
          if (gt) acc_q += q - m_mod_q;
          if (acc_q >= q) acc_q -= q;
          res2[e] = acc_q;
        }
        *reinterpret_cast<longlong2*>(out + (row0 + rr) * D + 2 * lane) =
            make_longlong2(res2[0], res2[1]);
      }
    }
    __syncwarp();                    // before the next tile refills buf
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

namespace {

// The launcher's checks of the wrapper's constants (ops/polymul_cuda.py
// coef_consts) for 2 <= q <= 32768: F h^2 < 2^31 (the int32 sums) and
// 2 F h^2 + q <= 2^32 (the shifted sum below 2^32), S a multiple of q not
// below F h^2, the Barrett constants; rows 16-byte aligned for cp.async.
bool coef_args_ok(const int64_t* a, const int64_t* b, const int64_t* out,
                  const CoefArgs& g, int flush) {
  const int64_t q = g.q, h = g.h, fh2 = static_cast<int64_t>(flush) * h * h;
  const bool consts =
      h == q / 2 &&
      (flush == 8 || flush == 16 || flush == 32 || flush == 64) &&
      fh2 < (1LL << 31) && 2 * fh2 + q <= (1LL << 32) && g.shift % q == 0 &&
      g.shift >= fh2 && g.shift < fh2 + q &&
      g.m32 == (1ULL << 32) / static_cast<uint64_t>(q) &&
      g.m64 == ~0ULL / static_cast<uint64_t>(q);
  const bool shape = g.n < (1LL << 31) && g.n_inner >= 1;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
      ((g.a_outer | g.a_inner | g.b_outer | g.b_inner) & 1) == 0;
  return consts && shape && aligned;
}

template <int F>
cudaError_t launch_coef(const int64_t* a, const int64_t* b, int64_t* out,
                        const CoefArgs& g, cudaStream_t stream) {
  // the shared-memory attribute and the blocks per SM, once (one device)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        polymul_coef_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(COEF_SMEM));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, polymul_coef_kernel<F>, COEF_THREADS, COEF_SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t tiles = (g.n + COEF_TILE - 1) / COEF_TILE;
  const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
  const unsigned blocks = static_cast<unsigned>(tiles < cap ? tiles : cap);
  polymul_coef_kernel<F><<<blocks, COEF_THREADS, COEF_SMEM, stream>>>(
      a, b, out, g);
  return cudaGetLastError();
}

}  // namespace

// out (n, 64) contiguous; row r = ro n_inner + ri reads a at a + ro a_outer
// + ri a_inner and b likewise (strides in int64 elements, 0 for a
// broadcast).  flush, shift, m32 and m64 from ops/polymul_cuda.py
// coef_consts(q); cudaErrorInvalidValue where the launcher's checks fail.
extern "C" int polymul_coef_launch(const int64_t* a, const int64_t* b,
                                   int64_t* out, int64_t n, int64_t n_inner,
                                   int64_t a_outer, int64_t a_inner,
                                   int64_t b_outer, int64_t b_inner,
                                   int64_t q, int flush, uint32_t shift,
                                   uint32_t m32, uint64_t m64, void* stream) {
  CoefArgs g;
  g.n = n;
  g.n_inner = n_inner;
  g.a_outer = a_outer;
  g.a_inner = a_inner;
  g.b_outer = b_outer;
  g.b_inner = b_inner;
  g.q = static_cast<uint32_t>(q);
  g.m32 = m32;
  g.shift = shift;
  g.h = static_cast<int32_t>(q / 2);
  g.m64 = m64;
  if (q < 2 || q > 32768 || !coef_args_ok(a, b, out, g, flush))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (flush) {
    case 64: err = launch_coef<64>(a, b, out, g, st); break;
    case 32: err = launch_coef<32>(a, b, out, g, st); break;
    case 16: err = launch_coef<16>(a, b, out, g, st); break;
    case 8: err = launch_coef<8>(a, b, out, g, st); break;
  }
  return static_cast<int>(err);
}

namespace {

template <int P>
cudaError_t launch_bhat(const int64_t* a, const int64_t* bhat,
                        const void* tables, const int64_t* consts,
                        int64_t* out, int64_t n, int64_t a_stride,
                        int64_t bhat_row_stride, int64_t bhat_prime_stride,
                        cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(P) *
      (2 * TABLE_WORDS * sizeof(uint2) + D * sizeof(uint32_t) +
       BHAT_WARPS * BHAT_TILE * BUF_STRIDE * sizeof(uint16_t));
  // the shared-memory attribute and the blocks per SM, once (one device)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        polymul_bhat_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, polymul_bhat_kernel<P>, BHAT_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t tiles = (n + BHAT_TILE - 1) / BHAT_TILE;
  const int64_t want = (tiles + BHAT_WARPS - 1) / BHAT_WARPS;
  const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  polymul_bhat_kernel<P><<<blocks, BHAT_THREADS, smem, stream>>>(
      a, bhat, static_cast<const uint2*>(tables), consts, out, n, a_stride,
      bhat_row_stride, bhat_prime_stride);
  return cudaGetLastError();
}

}  // namespace

// tables and consts as the kernel reads them; a, bhat and out 16-byte
// aligned (the wrapper's copies are).
extern "C" int polymul_bhat_launch(const int64_t* a, const int64_t* bhat,
                                   const void* tables, const int64_t* consts,
                                   int64_t* out, int64_t n, int64_t a_stride,
                                   int64_t bhat_row_stride,
                                   int64_t bhat_prime_stride, int P,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define LAB_BHAT(NP)                                                       \
  case NP:                                                                 \
    err = launch_bhat<NP>(a, bhat, tables, consts, out, n, a_stride,       \
                          bhat_row_stride, bhat_prime_stride, st);         \
    break;
  switch (P) {
    LAB_BHAT(1) LAB_BHAT(2) LAB_BHAT(3) LAB_BHAT(4) LAB_BHAT(5) LAB_BHAT(6)
  }
#undef LAB_BHAT
  return static_cast<int>(err);
}

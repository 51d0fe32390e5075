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
// reference).  The kernel is the tensor-core stream kernel of
// mma_stream.cuh (design, limbs, bounds) with this offset; what bounds it
// on the H100 is Threefry and the per-entry work on the CUDA cores.
// Shape limits (checked by ops/u1_cuda.py): d = 64, q <= 32513 or
// 2^32 < q < 2^33, r * t_1 * kappa below 2^31.
#include "mma_stream.cuh"

namespace {

struct U1Offset {
  uint64_t off_b;
  int kappa;
  int kappa1;
  __device__ uint64_t stream(int l) const {
    const int lm = l / kappa, lc = l - lm * kappa;   // l = lm * kappa + lc
    return off_b + static_cast<uint64_t>(lm) * kappa1 * kappa +
           static_cast<uint64_t>(lc) * D;
  }
  __device__ uint64_t row(int r) const {
    return static_cast<uint64_t>(r) * kappa * D;
  }
};

}  // namespace

// Returns the first launch error; cudaErrorInvalidValue for a mode the
// kernel does not take (the wrapper raises before that).  *bad is set for
// a digit beyond the limbs.
extern "C" int u1_bterm_launch(const int64_t* t_stream, int64_t* part,
                               int64_t* out, int* bad, int m_total, int kappa,
                               int kappa1, int64_t q, uint64_t barrett_m,
                               uint64_t off_b, uint32_t k0, uint32_t k1,
                               int digit_limbs, int tiles, int groups,
                               int splits, int l_per_split, void* stream) {
  const U1Offset off{off_b, kappa, kappa1};
  return static_cast<int>(launch_mma_stream(
      t_stream, part, out, bad, m_total * kappa, kappa1, q, barrett_m, k0, k1,
      off, digit_limbs, tiles, groups, splits, l_per_split,
      static_cast<cudaStream_t>(stream)));
}

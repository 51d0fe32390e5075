// The u1 outer commitment's B-term with the B matrices expanded in-kernel.
//
// Replaces labrador_tpu/ops/u1_pallas.py: u1_bterm_pallas (the pallas_call
// at line 164).  Computes
//     out[row] = sum_{m < r*t_1} sum_{col < kappa} B_m[row][col] (*) t_m[col]
// mod q, as one stream over l = m * kappa + col (the digit stream of
// t_dig (t_1, r, kappa, d) with m = i * t_1 + k).  B_m[row][col][c] sits at
//     off_b + m * kappa_1 * kappa + row * kappa * d + col * d + c
// (structs.rs:74-88, the B stride without a factor d kept as in the
// reference).  Shared ring-stream kernel: threefry.cuh.
// Bounds on the H100: integer issue — the kappa_1 x (r t_1 kappa d) B
// entries are each generated once (Threefry + 64-bit modulo), and each
// feeds 64 int32 products; global traffic is only the digit stream.
// Shape limits (checked by ops/u1_cuda.py): d = 64, q <= 32513,
// r * t_1 * kappa below 2^31; the stream is split over grid.y.
#include "threefry.cuh"

namespace {

struct U1Offset {
  uint64_t off_b;
  int kappa;
  int kappa1;
  __device__ uint64_t operator()(int l, int row) const {
    const uint64_t m = static_cast<uint64_t>(l / kappa);
    const uint64_t col = static_cast<uint64_t>(l % kappa);
    return off_b + m * static_cast<uint64_t>(kappa1) * kappa +
           static_cast<uint64_t>(row) * kappa * D + col * D;
  }
};

}  // namespace

extern "C" int u1_bterm_launch(const int64_t* t_stream, int64_t* part,
                               int64_t* out, int m_total, int kappa,
                               int kappa1, int64_t q, uint64_t off_b,
                               uint32_t k0, uint32_t k1, int splits,
                               void* stream) {
  const U1Offset off{off_b, kappa, kappa1};
  return static_cast<int>(launch_ring_stream(
      t_stream, part, out, 1, m_total * kappa, kappa1, q, k0, k1, off, splits,
      static_cast<cudaStream_t>(stream)));
}

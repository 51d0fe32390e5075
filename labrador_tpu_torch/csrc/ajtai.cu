// Ajtai commitment t = A s with the virtual CRS matrix A expanded in-kernel.
//
// Replaces labrador_tpu/ops/ajtai_pallas.py: ajtai_commit_pallas (the
// pallas_call at line 234).  Computes, for every witness vector j < r_eff
// and row < kappa,
//     t[j][row] = sum_{l < n} A[row][l] (*) s[j][l]   mod q,
// A[row][l][c] at CRS offset row * n * d + l * d + c (structs.rs:55-72).
// The witness is the right-hand side of the shared ring-stream kernel
// (threefry.cuh): each block generates its A row chunk once and applies it
// to four witness vectors.
// Bounds on the H100: integer issue (Threefry + 64-bit modulo per A entry
// per rhs group, int32 multiply + int64 add per product); no global traffic
// beyond the witness and t.
// Shape limits (checked by the wrapper, labrador_tpu_torch/ops/ajtai_cuda.py):
// d = 64, q <= 32513, r_eff * kappa * 64 and n * 64 below 2^31.  Unlike the
// Pallas kernel there is no 128-lane rule on r_eff * d and no int32 bound
// on n * d: the accumulator is int64.
#include "threefry.cuh"

namespace {

struct AjtaiOffset {
  uint64_t row_stride;  // n * d
  __device__ uint64_t operator()(int l, int row) const {
    return static_cast<uint64_t>(row) * row_stride +
           static_cast<uint64_t>(l) * D;
  }
};

}  // namespace

extern "C" int ajtai_commit_launch(const int64_t* s, int64_t* part,
                                   int64_t* out, int r_eff, int n, int kappa,
                                   int64_t q, uint32_t k0, uint32_t k1,
                                   int splits, void* stream) {
  const AjtaiOffset off{static_cast<uint64_t>(n) * D};
  return static_cast<int>(launch_ring_stream(
      s, part, out, r_eff, n, kappa, q, k0, k1, off, splits,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

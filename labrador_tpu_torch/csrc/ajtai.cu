// Ajtai commitment t = A s with the virtual CRS matrix A expanded in-kernel.
//
// Replaces labrador_tpu/ops/ajtai_pallas.py: ajtai_commit_pallas (the
// pallas_call at line 234), its small-q and its big-q branch (line 173;
// the signed witness in 4 int8 limbs per CRT prime there, one centred
// int64 here, with the 64-bit products and 128-bit sums of threefry.cuh's
// big mode).
// Computes, for every witness vector j < r_eff
// and row < kappa,
//     t[j][row] = sum_{l < n} A[row][l] (*) s[j][l]   mod q,
// A[row][l][c] at CRS offset row * n * d + l * d + c (structs.rs:55-72).
// The witness is the right-hand side of the shared ring-stream kernel
// (threefry.cuh): each block generates its A row chunk once and applies it
// to four witness vectors.
// Bounds on the H100: integer issue (Threefry + Barrett reduction per A entry
// per rhs group, int32 multiply + int64 add per product at small q, int64
// multiply + 128-bit add at big q); no global traffic beyond the witness
// and t.
// Shape limits (checked by the wrapper, labrador_tpu_torch/ops/ajtai_cuda.py):
// d = 64, q <= 32513 or 2^32 < q < 2^33 (a signed witness or
// residues, in [-q/2, q)),
// r_eff * kappa * 64 and n * 64 below 2^31.  Unlike the
// Pallas kernel there is no 128-lane rule on r_eff * d and no int32 bound
// on n * d: the accumulator is int64 (__int128 at big q).
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
                                   int64_t q, uint64_t barrett_m,
                                   uint32_t k0, uint32_t k1, int splits,
                                   void* stream) {
  const AjtaiOffset off{static_cast<uint64_t>(n) * D};
  return static_cast<int>(launch_ring_stream(
      s, part, out, r_eff, n, kappa, q, barrett_m, k0, k1, off, splits,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

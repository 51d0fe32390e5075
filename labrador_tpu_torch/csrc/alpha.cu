// The alpha-contractions of a folded statement on int8 tensor cores, with
// the base CRS generated in registers.
//
// Replaces no Pallas kernel: the JAX package contracts in XLA ops
// (labrador_tpu/recursion.py, _alpha_contract_a/_b/_cd), and the port's
// plain version (ops/alpha_cuda.py) expands the entries in torch ops and
// contracts them through the CRT transforms.  recursion.FoldedState's
// phi_alpha_modq needs, for each block of the base CRS, the sum of its
// rows rho weighted by alpha's part w of that block (kappa, kappa_1 or
// kappa_2 ring elements, residues in [0, q)):
//     out[row] = sum_rho M(rho, row) (*) w[rho]   mod q,
// the stream kernel of mma_stream.cuh with the stream over the rows rho
// and the output rows over the block's columns, one offset functor a pass:
//   A    (AlphaAOffset): A[rho][col] at rho * n * d + col * d; the n
//        columns;
//   B    (AlphaBOffset): B_m[rho][col] at off_b + m * kappa_1 * kappa +
//        rho * kappa * d + col * d (structs.rs:82: the stride between B
//        matrices has no factor d); rows m * kappa + col over the r * t_1
//        matrices, m = i * t_1 + k;
//   C/D  (AlphaCdPassOffset): M_{tri,k}[rho] at base + (tri * t_1 + k) *
//        kappa_2 * d + rho * d (structs.rs:106: the t_1 multiplier also
//        for C, whose t_used is t_2); rows tri * t_used + k.
// The alpha weights are full residues, not bounded digits: the functors
// derive from FullResidueOperand, so the kernel takes as many signed limbs
// of a weight as of an entry (5 at big q) and no digit check.  Their names
// hold neither "U1Offset" nor "CdOffset", by which
// perfbench/lib/roofline.py picks out the u1 and C/D kernels.  What bounds
// it on the H100 is Threefry on the CUDA cores, as for u1: the B pass
// streams as many entries as the u1 B-term at the same base (r t_1 kappa_1
// kappa d).  Shape limits (checked by ops/alpha_cuda.py): d = 64, q <=
// 32513 or 2^32 < q < 2^33, rows * d below 2^31.
#include "mma_stream.cuh"

namespace {

struct AlphaAOffset : FullResidueOperand {
  int n;
  __device__ uint64_t stream(int l) const {
    return static_cast<uint64_t>(l) * n * D;
  }
  __device__ uint64_t row(int r) const {
    return static_cast<uint64_t>(r) * D;
  }
};

struct AlphaBOffset : FullResidueOperand {
  uint64_t off_b;
  int kappa;
  int kappa1;
  __device__ uint64_t stream(int l) const {
    return static_cast<uint64_t>(l) * kappa * D;
  }
  __device__ uint64_t row(int r) const {
    const int m = r / kappa, col = r - m * kappa;   // r = m * kappa + col
    return off_b + static_cast<uint64_t>(m) * kappa1 * kappa +
           static_cast<uint64_t>(col) * D;
  }
};

struct AlphaCdPassOffset : FullResidueOperand {
  uint64_t base;
  int t_used;
  int t1;
  int kappa2;
  __device__ uint64_t stream(int l) const {
    return static_cast<uint64_t>(l) * D;
  }
  __device__ uint64_t row(int r) const {
    const uint64_t oc = static_cast<uint64_t>(r / t_used) * t1 + r % t_used;
    return base + oc * static_cast<uint64_t>(kappa2) * D;
  }
};

}  // namespace

// Each entry point: w (L, D) the weights (residues in [0, q)), part
// (splits, rows, D) scratch, out (rows, D) the sums mod q in [0, q); keys
// the CRS key as a (1, 2) array of uint32 words in int64 on the device.
// Returns the first launch error; cudaErrorInvalidValue for a shape the
// kernel does not take (the wrapper raises before that).

// out (n, D): sum over the kappa rows of A.
extern "C" int alpha_a_launch(const int64_t* w, int64_t* part, int64_t* out,
                              int kappa, int n, int64_t q,
                              uint64_t barrett_m, const int64_t* keys,
                              int tiles, int groups, int splits,
                              int l_per_split, void* stream) {
  const AlphaAOffset off{{}, n};
  const ThreefrySrc src{keys, static_cast<uint64_t>(q), barrett_m};
  return static_cast<int>(launch_mma_full(
      w, part, out, kappa, n, q, src, off, tiles, groups, splits,
      l_per_split, static_cast<cudaStream_t>(stream)));
}

// out (m_total * kappa, D): sum over the kappa1 rows of each B_m.
extern "C" int alpha_b_launch(const int64_t* w, int64_t* part, int64_t* out,
                              int kappa1, int m_total, int kappa,
                              uint64_t off_b, int64_t q, uint64_t barrett_m,
                              const int64_t* keys, int tiles, int groups,
                              int splits, int l_per_split, void* stream) {
  const AlphaBOffset off{{}, off_b, kappa, kappa1};
  const ThreefrySrc src{keys, static_cast<uint64_t>(q), barrett_m};
  return static_cast<int>(launch_mma_full(
      w, part, out, kappa1, m_total * kappa, q, src, off, tiles, groups,
      splits, l_per_split, static_cast<cudaStream_t>(stream)));
}

// out (n_tri * t_used, D): sum over the kappa2 rows of each C or D column
// vector from base.
extern "C" int alpha_cd_launch(const int64_t* w, int64_t* part, int64_t* out,
                               int kappa2, int n_tri, int t_used, int t1,
                               uint64_t base, int64_t q, uint64_t barrett_m,
                               const int64_t* keys, int tiles, int groups,
                               int splits, int l_per_split, void* stream) {
  const AlphaCdPassOffset off{{}, base, t_used, t1, kappa2};
  const ThreefrySrc src{keys, static_cast<uint64_t>(q), barrett_m};
  return static_cast<int>(launch_mma_full(
      w, part, out, kappa2, n_tri * t_used, q, src, off, tiles, groups,
      splits, l_per_split, static_cast<cudaStream_t>(stream)));
}

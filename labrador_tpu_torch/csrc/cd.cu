// The u1 C-term and the u2 D-term: sums of CRS column vectors times digit
// polynomials over the (i <= j, k) triangle stream.
//
// Replaces labrador_tpu/ops/cd_pallas.py: cd_sum_pallas (the pallas_call at
// line 183), small-q and big-q (line 128) branches.  Computes
//     out[row] = sum_{lin < L} M_lin[row] (*) dig[lin]   mod q,
// lin = tri * t_used + k over L = n_tri * t_used stream entries, with the
// column vector M_lin (kappa_2 ring elements) at
//     base + oc * kappa_2 * d + row * d,   oc = tri * t_1 + k,
// the t_1 multiplier applying to C (t_used = t_2) as well as D
// (structs.rs:106), so oc is not affine in lin when t_used < t_1.
// base is the C or the D region start.  Shared ring-stream kernel:
// threefry.cuh.  The stream is not padded: ragged chunks stop at L.
// Bounds on the H100: integer issue (one Threefry + Barrett reduction per
// entry of the kappa_2 x L x d column block, 64 products per entry).
// Shape limits (checked by ops/cd_cuda.py): d = 64, q <= 32513 or
// 2^32 < q < 2^33 (signed digits),
// L and kappa_2 below 2^31.
#include "threefry.cuh"

namespace {

struct CdOffset {
  uint64_t base;
  int t_used;
  int t1;
  int kappa2;
  __device__ uint64_t operator()(int l, int row) const {
    const uint64_t oc = static_cast<uint64_t>(l / t_used) * t1 + l % t_used;
    return base + oc * static_cast<uint64_t>(kappa2) * D +
           static_cast<uint64_t>(row) * D;
  }
};

}  // namespace

extern "C" int cd_sum_launch(const int64_t* dig, int64_t* part, int64_t* out,
                             int L, int t_used, int t1, int kappa2, int64_t q,
                             uint64_t barrett_m, uint64_t base, uint32_t k0,
                             uint32_t k1,
                             int splits, void* stream) {
  const CdOffset off{base, t_used, t1, kappa2};
  return static_cast<int>(launch_ring_stream(
      dig, part, out, 1, L, kappa2, q, barrett_m, k0, k1, off, splits,
      static_cast<cudaStream_t>(stream)));
}

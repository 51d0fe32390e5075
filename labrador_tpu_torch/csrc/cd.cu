// The u1 C-term and the u2 D-term: sums of CRS column vectors times digit
// polynomials over the (i <= j, k) triangle stream, on int8 tensor cores.
//
// Replaces labrador_tpu/ops/cd_pallas.py: cd_sum_pallas (the pallas_call at
// line 183), small-q and big-q (line 128) branches.  Computes
//     out[row] = sum_{lin < L} M_lin[row] (*) dig[lin]   mod q,
// lin = tri * t_used + k over L = n_tri * t_used stream entries, with the
// column vector M_lin (kappa_2 ring elements) at
//     base + oc * kappa_2 * d + row * d,   oc = tri * t_1 + k,
// the t_1 multiplier applying to C (t_used = t_2) as well as D
// (structs.rs:106), so oc is not affine in lin when t_used < t_1.
// base is the C or the D region start.  The kernel is the tensor-core
// stream kernel of mma_stream.cuh (design, limbs, bounds) with this
// offset: the g digits of C take digit_limbs(b_2) limbs, the h digits of
// D digit_limbs(b_1), as the Pallas kernel counts them.  What bounds it
// on the H100 is Threefry and the per-entry work on the CUDA cores.  At
// kappa_2 = 16 (the folded instances) a block's 8 warps are 2 row tiles
// times 4 l-groups over L ~ 10^5 ring elements.
// Range mode: the stream entries l0 .. l0 + L - 1 only (one shard of the
// (tri, k) stream on a (dp, rows) mesh, as the JAX package's
// _cd_sharded_partial cuts it), lin = l0 + l for the l-th local digit;
// the result is this shard's partial.  l0 = 0 over the whole stream is
// the whole sum.
// Shape limits (checked by ops/cd_cuda.py): d = 64, q <= 32513 or
// 2^32 < q < 2^33, L and kappa_2 * d below 2^31.
#include "mma_stream.cuh"

namespace {

struct CdOffset {
  uint64_t base;
  int t_used;
  int t1;
  int kappa2;
  int l0;       // the stream index of the first local digit
  __device__ uint64_t stream(int l) const {
    const int lin = l0 + l;
    const uint64_t oc =
        static_cast<uint64_t>(lin / t_used) * t1 + lin % t_used;
    return base + oc * static_cast<uint64_t>(kappa2) * D;
  }
  __device__ uint64_t row(int r) const {
    return static_cast<uint64_t>(r) * D;
  }
};

}  // namespace

extern "C" int cd_sum_launch(const int64_t* dig, int64_t* part, int64_t* out,
                             int* bad, int L, int l0, int t_used, int t1,
                             int kappa2, int64_t q,
                             uint64_t barrett_m, uint64_t base, uint32_t k0,
                             uint32_t k1, int digit_limbs, int tiles,
                             int groups, int splits, int l_per_split,
                             void* stream) {
  const CdOffset off{base, t_used, t1, kappa2, l0};
  return static_cast<int>(launch_mma_stream(
      dig, part, out, bad, L, kappa2, q, barrett_m, k0, k1, off, digit_limbs,
      tiles, groups, splits, l_per_split, static_cast<cudaStream_t>(stream)));
}

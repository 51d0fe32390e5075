// The Fiat-Shamir oracle's SHA-256 counter-mode stream (the JL matrices'
// words) on the CUDA cores, one launch a call.
//
// Replaces no Pallas kernel: the JAX package hashes in jnp ops
// (labrador_tpu/ops/sha256.py).  The port's plain route, sha256_batch
// (ops/sha256.py) over the batch of messages, dispatches one torch op per
// step of the compress function: 2,924 ops for the 524,288 blocks of one
// 2^14 JL attempt, whose launches bound the host at about 29 ms for about
// 8 ms of device work.  This kernel does the same work in one launch.
//
// Computes, for key r < R and block j < nb, the SHA-256 digest of the
// one-block message K_r || dom || j (10 big-endian 32-bit words; dom =
// "BITS" for the key streams, FS_SPEC.md §5), padded as SHA-256 pads 40
// bytes: 0x80000000, four zero words and the bit length 320.  Its 8 words
// go as int64 values in [0, 2^32) to out[(r * nb + j) * 8 ..], the
// (R, nb * 8) stream of ops/sha_prng.stream_device.
//
// Design: one thread per message (grid.y the key, grid.x the blocks of its
// stream), the whole compress in registers: a rolling 16-word schedule,
// rotations by __funnelshift_r, H0 added at the end; no shared memory.
// The thread's 64 output bytes go as four 16-byte stores.  Operations bound
// it: a block is 2,168 two-input int32 operations (64 rounds of 24, 48
// schedule steps of 13, 8 final adds), which the three-input LOP3 and IADD3
// and the one-instruction rotation (SHF) take in 1,384 instructions (64
// rounds of 14, 48 steps of 10, 8 adds), 1,331 once the message's constant
// words (dom, the padding, H0) fold.  524,288 blocks thus take at least
// 0.042 ms at 132 SMs x 64 int32 lanes x 1.98 GHz, against 0.010 ms for
// their 33.5 MB of output at 3.35 TB/s.
// Shape limits (checked by ops/sha_cuda.py): 1 to 65535 keys, 1 to 2^32
// blocks a key.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__constant__ uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

__constant__ uint32_t SHA_H0[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ long long word(uint32_t x) {
  return static_cast<long long>(x);
}

__global__ void __launch_bounds__(THREADS)
    sha_stream_kernel(const int64_t* __restrict__ keys,
                      int64_t* __restrict__ out, int64_t nb, uint32_t dom) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= nb) return;
  const int64_t r = blockIdx.y;
  uint32_t w[16];
  const longlong2* key = reinterpret_cast<const longlong2*>(keys + r * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const longlong2 k = key[i];
    w[2 * i] = static_cast<uint32_t>(k.x);
    w[2 * i + 1] = static_cast<uint32_t>(k.y);
  }
  w[8] = dom;
  w[9] = static_cast<uint32_t>(j);
  w[10] = 0x80000000u;
  w[11] = w[12] = w[13] = w[14] = 0;
  w[15] = 320;   // 10 words of 32 bits

  uint32_t a = SHA_H0[0], b = SHA_H0[1], c = SHA_H0[2], d = SHA_H0[3];
  uint32_t e = SHA_H0[4], f = SHA_H0[5], g = SHA_H0[6], h = SHA_H0[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {   // word i of the schedule overwrites word i - 16
      const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
      w[i & 15] += (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(i - 7) & 15] +
                   (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        (g ^ (e & (f ^ g))) + SHA_K[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) | (c & (a | b)));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  longlong2* dst = reinterpret_cast<longlong2*>(out + (r * nb + j) * 8);
  dst[0] = make_longlong2(word(SHA_H0[0] + a), word(SHA_H0[1] + b));
  dst[1] = make_longlong2(word(SHA_H0[2] + c), word(SHA_H0[3] + d));
  dst[2] = make_longlong2(word(SHA_H0[4] + e), word(SHA_H0[5] + f));
  dst[3] = make_longlong2(word(SHA_H0[6] + g), word(SHA_H0[7] + h));
}

}  // namespace

// The stream of n_keys keys, nb blocks each, into out (n_keys, nb * 8):
// keys (n_keys, 8) holds each key's words as int64 values in [0, 2^32),
// both on the device and 16-byte aligned.  Returns the launch error, or
// cudaErrorInvalidValue for a shape beyond the limits above.
extern "C" int sha_stream_launch(const int64_t* keys, int64_t* out,
                                 int n_keys, int64_t nb, uint32_t dom,
                                 void* stream) {
  if (n_keys < 1 || n_keys > 65535 || nb < 1 || nb > (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nb + THREADS - 1) / THREADS),
                  static_cast<unsigned>(n_keys));
  sha_stream_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, out, nb, dom);
  return static_cast<int>(cudaGetLastError());
}

// ChaCha20-compatible CRS coefficient generator: the port's own copy of
// labrador_tpu/native/chacha_compat.cpp, with the same extern "C" functions.
//
// Reproduces, in C++, the reference implementation's lazy random oracle
// exactly as coded at structs.rs:147-171:
//   * every coefficient re-keys a fresh ChaCha20Rng with seed =
//     base_seed + global_offset (256-bit big-endian addition, mirroring the
//     BigUint arithmetic at structs.rs:55-144 and the big-endian
//     increment_seed at structs.rs:155-165);
//   * the coefficient is rng.gen_range(0..q), i.e. rand 0.8's
//     UniformInt<i128>::sample_single widening-multiply-with-rejection over
//     a u128 drawn as (next_u64() as low, next_u64() as high);
//   * ChaCha20Rng keystream per rand_chacha: RFC-8439 quarter rounds, key =
//     seed (LE words), 64-bit block counter in words 12..13, stream id 0 in
//     words 14..15; u32 outputs are the post-addition state words in order,
//     u64 = lo | (hi << 32).
//
// The port fills crs.MaterializedCRS's table with it (on the host; the
// commitment kernels read the table on the card); the Threefry CRS is the
// port's runtime default.
//
// Built at first use by labrador_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o libchacha_compat.so chacha_compat.cpp

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

static void chacha20_block(const uint32_t key[8], uint64_t counter,
                           uint32_t out[16]) {
    uint32_t s[16] = {
        0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
        key[0], key[1], key[2], key[3],
        key[4], key[5], key[6], key[7],
        (uint32_t)(counter & 0xffffffffu), (uint32_t)(counter >> 32),
        0u, 0u,
    };
    uint32_t x[16];
    std::memcpy(x, s, sizeof(x));
#define QR(a, b, c, d)                                   \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl32(x[d], 16); \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl32(x[b], 12); \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl32(x[d], 8);  \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl32(x[b], 7);
    for (int i = 0; i < 10; i++) {
        QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
        QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
    }
#undef QR
    for (int i = 0; i < 16; i++) out[i] = x[i] + s[i];
}

// Streaming u64 reader over the ChaCha20 keystream (rand_chacha order).
struct ChaChaStream {
    uint32_t key[8];
    uint64_t counter = 0;
    uint32_t block[16];
    int word = 16;  // force initial refill

    void refill() {
        chacha20_block(key, counter, block);
        counter++;
        word = 0;
    }
    uint32_t next_u32() {
        if (word >= 16) refill();
        return block[word++];
    }
    uint64_t next_u64() {
        uint64_t lo = next_u32();
        uint64_t hi = next_u32();
        return lo | (hi << 32);
    }
    u128 next_u128() {
        // rand 0.8 Standard for u128: low u64 first, then high
        u128 lo = next_u64();
        u128 hi = next_u64();
        return (hi << 64) | lo;
    }
};

// (hi, lo) of a 128x128 -> 256-bit product
static void wmul128(u128 a, u128 b, u128* hi, u128* lo) {
    u128 a_lo = (uint64_t)a, a_hi = a >> 64;
    u128 b_lo = (uint64_t)b, b_hi = b >> 64;
    u128 ll = a_lo * b_lo;
    u128 lh = a_lo * b_hi;
    u128 hl = a_hi * b_lo;
    u128 hh = a_hi * b_hi;
    u128 mid = (ll >> 64) + (uint64_t)lh + (uint64_t)hl;
    *lo = (mid << 64) | (uint64_t)ll;
    *hi = hh + (lh >> 64) + (hl >> 64) + (mid >> 64);
}

static int leading_zeros_u128(u128 v) {
    if (v == 0) return 128;
    int n = 0;
    for (u128 mask = (u128)1 << 127; !(v & mask); mask >>= 1) n++;
    return n;
}

// rand 0.8 UniformInt<i128>::sample_single for range [0, q)
static u128 gen_range_u128(ChaChaStream& rng, u128 range) {
    u128 zone = (range << leading_zeros_u128(range)) - 1;
    for (;;) {
        u128 v = rng.next_u128();
        u128 hi, lo;
        wmul128(v, range, &hi, &lo);
        if (lo <= zone) return hi;
    }
}

// 256-bit big-endian seed arithmetic (BigUint layout, structs.rs:47-53)
static void seed_add_u64(const uint8_t base[32], uint64_t add,
                         uint8_t out[32]) {
    std::memcpy(out, base, 32);
    unsigned carry = 0;
    for (int i = 31; i >= 0 && (add || carry); i--) {
        unsigned v = out[i] + (unsigned)(add & 0xff) + carry;
        out[i] = (uint8_t)v;
        carry = v >> 8;
        add >>= 8;
    }
}

extern "C" {

// out[i] = coefficient drawn from seed base+offset+i, for i in [0, count)
void crs_coeffs(const uint8_t base_seed[32], uint64_t offset,
                uint64_t count, uint64_t q, int64_t* out) {
    for (uint64_t i = 0; i < count; i++) {
        uint8_t seed[32];
        seed_add_u64(base_seed, offset + i, seed);
        ChaChaStream rng;
        // rand_chacha from_seed: key = seed bytes as 8 LE u32 words
        for (int w = 0; w < 8; w++) {
            rng.key[w] = (uint32_t)seed[4 * w]
                       | ((uint32_t)seed[4 * w + 1] << 8)
                       | ((uint32_t)seed[4 * w + 2] << 16)
                       | ((uint32_t)seed[4 * w + 3] << 24);
        }
        out[i] = (int64_t)gen_range_u128(rng, (u128)q);
    }
}

// raw keystream words for validation against RFC 8439 test vectors
void chacha20_keystream(const uint8_t key_bytes[32], uint64_t counter,
                        uint32_t out[16]) {
    uint32_t key[8];
    for (int w = 0; w < 8; w++) {
        key[w] = (uint32_t)key_bytes[4 * w]
               | ((uint32_t)key_bytes[4 * w + 1] << 8)
               | ((uint32_t)key_bytes[4 * w + 2] << 16)
               | ((uint32_t)key_bytes[4 * w + 3] << 24);
    }
    chacha20_block(key, counter, out);
}

}  // extern "C"

// Sealed boxes (X25519 + XSalsa20-Poly1305) and Ed25519 detached
// signatures, wire-identical to libsodium 1.0.18, with no dependency.
//
// The protocol seals every share vector to a clerk's X25519 key and signs
// every encryption key with Ed25519. These are the constructions of
// libsodium's crypto_box_seal / crypto_box_seal_open and
// crypto_sign_detached / crypto_sign_verify_detached, byte for byte:
//
// - sealed box: epk || crypto_box_easy(m, nonce, pk, esk), nonce =
//   BLAKE2b-192(epk || pk), the box = MAC (16 bytes) || XSalsa20(m) under the
//   key HSalsa20(X25519(esk, pk), 0); 48 bytes over the message;
// - Ed25519 (RFC 8032): the secret key is seed || A, the signature R || S,
//   deterministic; verification rejects S >= L, an R or A of small order, a
//   non-canonical A and an A that does not decode, and accepts only when
//   the encoding of [S]B - [h]A equals R byte for byte.
//
// Field elements of GF(2^255 - 19) are 5 limbs of 51 bits multiplied through
// unsigned __int128. Key generation, X25519 and signing are constant time:
// the secret scalar drives no branch and no memory index. Verification runs
// in variable time. Randomness comes from getrandom(2), and a call fails
// when it does. Nothing keeps state in statics: the batch open
// (sealed_batch.cpp) calls this code from many threads.

#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include <sys/random.h>

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

inline u32 load32(const u8* p) {
    return u32(p[0]) | (u32(p[1]) << 8) | (u32(p[2]) << 16) | (u32(p[3]) << 24);
}
inline void store32(u8* p, u32 v) {
    for (int i = 0; i < 4; ++i) p[i] = u8(v >> (8 * i));
}
inline u64 load64(const u8* p) {
    return u64(load32(p)) | (u64(load32(p + 4)) << 32);
}
inline void store64(u8* p, u64 v) {
    for (int i = 0; i < 8; ++i) p[i] = u8(v >> (8 * i));
}
inline u64 load64_be(const u8* p) {
    u64 v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
    return v;
}
inline void store64_be(u8* p, u64 v) {
    for (int i = 0; i < 8; ++i) p[7 - i] = u8(v >> (8 * i));
}

// writes that the compiler may not drop: secrets leave no copy behind
void wipe(void* p, size_t n) {
    volatile u8* v = static_cast<volatile u8*>(p);
    while (n--) *v++ = 0;
}

// 0 when a == b over n bytes, else -1; time independent of the contents
int verify_n(const u8* a, const u8* b, size_t n) {
    u32 d = 0;
    for (size_t i = 0; i < n; ++i) d |= u32(a[i] ^ b[i]);
    return int((1 & ((d - 1) >> 8)) - 1);
}

int random_fill(u8* buf, size_t n) {
    while (n > 0) {
        ssize_t got = getrandom(buf, n, 0);
        if (got < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        buf += got;
        n -= size_t(got);
    }
    return 0;
}

// ------------------------------------------------------------- SHA-512

constexpr u64 kSha512K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};
// SHA-512's initial state, which is also BLAKE2b's IV
constexpr u64 kIV512[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512 {
    u64 h[8];
    u8 buf[128];
    size_t fill = 0;
    u64 total = 0;  // bytes hashed; messages stay far below 2^61 bytes

    Sha512() { memcpy(h, kIV512, sizeof h); }

    void block(const u8* p) {
        u64 w[80];
        for (int i = 0; i < 16; ++i) w[i] = load64_be(p + 8 * i);
        for (int i = 16; i < 80; ++i) {
            u64 s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
            u64 s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u64 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
        for (int i = 0; i < 80; ++i) {
            u64 t1 = k + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                     ((e & f) ^ (~e & g)) + kSha512K[i] + w[i];
            u64 t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                     ((a & b) ^ (a & c) ^ (b & c));
            k = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += k;
    }

    void update(const u8* m, size_t n) {
        total += n;
        if (fill > 0) {
            size_t take = n < 128 - fill ? n : 128 - fill;
            memcpy(buf + fill, m, take);
            fill += take; m += take; n -= take;
            if (fill < 128) return;
            block(buf);
            fill = 0;
        }
        for (; n >= 128; m += 128, n -= 128) block(m);
        memcpy(buf, m, n);
        fill = n;
    }

    void final(u8 out[64]) {
        u64 bits = total << 3;
        buf[fill++] = 0x80;
        if (fill > 112) {
            memset(buf + fill, 0, 128 - fill);
            block(buf);
            fill = 0;
        }
        memset(buf + fill, 0, 120 - fill);
        store64_be(buf + 120, bits);  // the high 64 bits of the length stay 0
        block(buf);
        for (int i = 0; i < 8; ++i) store64_be(out + 8 * i, h[i]);
        wipe(this, sizeof *this);
    }
};

// --------------------------------------------------------- BLAKE2b (unkeyed)

constexpr u8 kBlake2bSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

void blake2b_compress(u64 h[8], const u8 block[128], u64 t, bool last) {
    u64 m[16], v[16];
    for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
    for (int i = 0; i < 8; ++i) {
        v[i] = h[i];
        v[i + 8] = kIV512[i];
    }
    v[12] ^= t;  // the high word of the 128-bit counter stays 0
    if (last) v[14] = ~v[14];
    auto g = [&](int r, int i, int a, int b, int c, int d) {
        v[a] = v[a] + v[b] + m[kBlake2bSigma[r][2 * i]];
        v[d] = rotr64(v[d] ^ v[a], 32);
        v[c] = v[c] + v[d];
        v[b] = rotr64(v[b] ^ v[c], 24);
        v[a] = v[a] + v[b] + m[kBlake2bSigma[r][2 * i + 1]];
        v[d] = rotr64(v[d] ^ v[a], 16);
        v[c] = v[c] + v[d];
        v[b] = rotr64(v[b] ^ v[c], 63);
    };
    for (int r = 0; r < 12; ++r) {
        g(r, 0, 0, 4, 8, 12);
        g(r, 1, 1, 5, 9, 13);
        g(r, 2, 2, 6, 10, 14);
        g(r, 3, 3, 7, 11, 15);
        g(r, 4, 0, 5, 10, 15);
        g(r, 5, 1, 6, 11, 12);
        g(r, 6, 2, 7, 8, 13);
        g(r, 7, 3, 4, 9, 14);
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// unkeyed BLAKE2b of `in` with an `outlen`-byte digest (outlen <= 64)
void blake2b(u8* out, size_t outlen, const u8* in, size_t inlen) {
    u64 h[8];
    memcpy(h, kIV512, sizeof h);
    h[0] ^= 0x01010000ULL ^ u64(outlen);
    u8 block[128];
    u64 t = 0;
    while (inlen > 128) {
        t += 128;
        blake2b_compress(h, in, t, false);
        in += 128;
        inlen -= 128;
    }
    memset(block, 0, sizeof block);
    memcpy(block, in, inlen);
    t += inlen;
    blake2b_compress(h, block, t, true);
    u8 full[64];
    for (int i = 0; i < 8; ++i) store64(full + 8 * i, h[i]);
    memcpy(out, full, outlen);
}

// ------------------------------------------------- Salsa20, HSalsa20, XSalsa20

inline u32 rotl32(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

void salsa20_rounds(u32 x[16]) {
    for (int i = 0; i < 10; ++i) {
        x[4] ^= rotl32(x[0] + x[12], 7);   x[8] ^= rotl32(x[4] + x[0], 9);
        x[12] ^= rotl32(x[8] + x[4], 13);  x[0] ^= rotl32(x[12] + x[8], 18);
        x[9] ^= rotl32(x[5] + x[1], 7);    x[13] ^= rotl32(x[9] + x[5], 9);
        x[1] ^= rotl32(x[13] + x[9], 13);  x[5] ^= rotl32(x[1] + x[13], 18);
        x[14] ^= rotl32(x[10] + x[6], 7);  x[2] ^= rotl32(x[14] + x[10], 9);
        x[6] ^= rotl32(x[2] + x[14], 13);  x[10] ^= rotl32(x[6] + x[2], 18);
        x[3] ^= rotl32(x[15] + x[11], 7);  x[7] ^= rotl32(x[3] + x[15], 9);
        x[11] ^= rotl32(x[7] + x[3], 13);  x[15] ^= rotl32(x[11] + x[7], 18);
        x[1] ^= rotl32(x[0] + x[3], 7);    x[2] ^= rotl32(x[1] + x[0], 9);
        x[3] ^= rotl32(x[2] + x[1], 13);   x[0] ^= rotl32(x[3] + x[2], 18);
        x[6] ^= rotl32(x[5] + x[4], 7);    x[7] ^= rotl32(x[6] + x[5], 9);
        x[4] ^= rotl32(x[7] + x[6], 13);   x[5] ^= rotl32(x[4] + x[7], 18);
        x[11] ^= rotl32(x[10] + x[9], 7);  x[8] ^= rotl32(x[11] + x[10], 9);
        x[9] ^= rotl32(x[8] + x[11], 13);  x[10] ^= rotl32(x[9] + x[8], 18);
        x[12] ^= rotl32(x[15] + x[14], 7); x[13] ^= rotl32(x[12] + x[15], 9);
        x[14] ^= rotl32(x[13] + x[12], 13); x[15] ^= rotl32(x[14] + x[13], 18);
    }
}

// "expand 32-byte k"
constexpr u32 kSigma[4] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574};

// the Salsa20 state of a 32-byte key around the four middle words
void salsa20_state(u32 x[16], const u8 key[32], const u32 middle[4]) {
    x[0] = kSigma[0];
    for (int i = 0; i < 4; ++i) x[1 + i] = load32(key + 4 * i);
    x[5] = kSigma[1];
    for (int i = 0; i < 4; ++i) x[6 + i] = middle[i];
    x[10] = kSigma[2];
    for (int i = 0; i < 4; ++i) x[11 + i] = load32(key + 16 + 4 * i);
    x[15] = kSigma[3];
}

void hsalsa20(u8 out[32], const u8 in[16], const u8 key[32]) {
    u32 middle[4], x[16];
    for (int i = 0; i < 4; ++i) middle[i] = load32(in + 4 * i);
    salsa20_state(x, key, middle);
    salsa20_rounds(x);
    const int pick[8] = {0, 5, 10, 15, 6, 7, 8, 9};
    for (int i = 0; i < 8; ++i) store32(out + 4 * i, x[pick[i]]);
    wipe(x, sizeof x);
}

// c = m XOR the Salsa20 keystream of (key, nonce8) from block `counter` on;
// the block counter is 64 bits wide, carried from its low word to its high
void salsa20_xor(u8* c, const u8* m, size_t n, const u8 nonce[8], u64 counter,
                 const u8 key[32]) {
    u32 middle[4] = {load32(nonce), load32(nonce + 4), 0, 0};
    u32 in[16], x[16];
    u8 ks[64];
    while (n > 0) {
        middle[2] = u32(counter);
        middle[3] = u32(counter >> 32);
        salsa20_state(in, key, middle);
        memcpy(x, in, sizeof x);
        salsa20_rounds(x);
        for (int i = 0; i < 16; ++i) store32(ks + 4 * i, x[i] + in[i]);
        size_t take = n < 64 ? n : 64;
        for (size_t i = 0; i < take; ++i) c[i] = m[i] ^ ks[i];
        c += take;
        m += take;
        n -= take;
        ++counter;
    }
    wipe(in, sizeof in);
    wipe(x, sizeof x);
    wipe(ks, sizeof ks);
}

// ------------------------------------------------------------ Poly1305

// 130-bit accumulator and key in limbs of 44, 44 and 42 bits
struct Poly1305 {
    u64 r[3], s[2], h[3] = {0, 0, 0}, pad[2];

    explicit Poly1305(const u8 key[32]) {
        u64 t0 = load64(key), t1 = load64(key + 8);
        r[0] = t0 & 0xffc0fffffffULL;
        r[1] = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
        r[2] = (t1 >> 24) & 0x00ffffffc0fULL;
        s[0] = r[1] * (5 << 2);
        s[1] = r[2] * (5 << 2);
        pad[0] = load64(key + 16);
        pad[1] = load64(key + 24);
    }

    // one 16-byte block; hibit is 2^128 (as 1 << 40 in the top limb) for a
    // full block and 0 for the final one, whose padding byte is in `m`
    void block(const u8 m[16], u64 hibit) {
        constexpr u64 m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
        u64 t0 = load64(m), t1 = load64(m + 8);
        u64 h0 = h[0] + (t0 & m44);
        u64 h1 = h[1] + (((t0 >> 44) | (t1 << 20)) & m44);
        u64 h2 = h[2] + (((t1 >> 24) & m42) | hibit);
        u128 d0 = u128(h0) * r[0] + u128(h1) * s[1] + u128(h2) * s[0];
        u128 d1 = u128(h0) * r[1] + u128(h1) * r[0] + u128(h2) * s[1];
        u128 d2 = u128(h0) * r[2] + u128(h1) * r[1] + u128(h2) * r[0];
        u64 c = u64(d0 >> 44);
        h0 = u64(d0) & m44;
        d1 += c;
        c = u64(d1 >> 44);
        h1 = u64(d1) & m44;
        d2 += c;
        c = u64(d2 >> 42);
        h2 = u64(d2) & m42;
        h0 += c * 5;
        c = h0 >> 44;
        h0 &= m44;
        h1 += c;
        h[0] = h0;
        h[1] = h1;
        h[2] = h2;
    }

    void update(const u8* m, size_t n) {
        for (; n >= 16; m += 16, n -= 16) block(m, u64(1) << 40);
        if (n > 0) {
            u8 last[16] = {0};
            memcpy(last, m, n);
            last[n] = 1;
            block(last, 0);
        }
    }

    void final(u8 mac[16]) {
        constexpr u64 m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
        u64 h0 = h[0], h1 = h[1], h2 = h[2], c;
        // carry fully: h0, h1 < 2^44, h2 < 2^42 (h < 2^130)
        c = h1 >> 44; h1 &= m44; h2 += c;
        c = h2 >> 42; h2 &= m42; h0 += c * 5;
        c = h0 >> 44; h0 &= m44; h1 += c;
        c = h1 >> 44; h1 &= m44; h2 += c;
        c = h2 >> 42; h2 &= m42; h0 += c * 5;
        c = h0 >> 44; h0 &= m44; h1 += c;
        // g = h + 5 - 2^130: non-negative exactly when h >= p = 2^130 - 5
        u64 g0 = h0 + 5;
        c = g0 >> 44; g0 &= m44;
        u64 g1 = h1 + c;
        c = g1 >> 44; g1 &= m44;
        u64 g2 = h2 + c - (u64(1) << 42);
        u64 keep_g = (g2 >> 63) - 1;  // all ones when g2 did not borrow
        h0 = (h0 & ~keep_g) | (g0 & keep_g);
        h1 = (h1 & ~keep_g) | (g1 & keep_g);
        h2 = (h2 & ~keep_g) | (g2 & keep_g);
        // mac = (h + pad) mod 2^128
        u64 t0 = pad[0], t1 = pad[1];
        h0 += t0 & m44;
        c = h0 >> 44; h0 &= m44;
        h1 += (((t0 >> 44) | (t1 << 20)) & m44) + c;
        c = h1 >> 44; h1 &= m44;
        h2 += ((t1 >> 24) & m42) + c;
        h2 &= m42;
        store64(mac, h0 | (h1 << 44));
        store64(mac + 8, (h1 >> 20) | (h2 << 24));
        wipe(this, sizeof *this);
    }
};

// ----------------------------------------------------- GF(2^255 - 19)

// 5 limbs of 51 bits; every function leaves each limb below 2^52
struct Fe {
    u64 v[5];
};
constexpr u64 kMask51 = (u64(1) << 51) - 1;

constexpr Fe kFeD = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
                      0x739c663a03cbbULL, 0x52036cee2b6ffULL}};
constexpr Fe kFeD2 = {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
                       0x6738cc7407977ULL, 0x2406d9dc56dffULL}};
constexpr Fe kFeSqrtM1 = {{0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
                           0x78595a6804c9eULL, 0x2b8324804fc1dULL}};

inline Fe fe_small(u64 x) { return Fe{{x, 0, 0, 0, 0}}; }

inline void fe_carry(Fe& h) {
    u64 c;
    c = h.v[0] >> 51; h.v[0] &= kMask51; h.v[1] += c;
    c = h.v[1] >> 51; h.v[1] &= kMask51; h.v[2] += c;
    c = h.v[2] >> 51; h.v[2] &= kMask51; h.v[3] += c;
    c = h.v[3] >> 51; h.v[3] &= kMask51; h.v[4] += c;
    c = h.v[4] >> 51; h.v[4] &= kMask51; h.v[0] += 19 * c;
}

inline Fe fe_add(const Fe& f, const Fe& g) {
    Fe h;
    for (int i = 0; i < 5; ++i) h.v[i] = f.v[i] + g.v[i];
    fe_carry(h);
    return h;
}

// f - g + 4p: every limb of 4p exceeds 2^52 > g's limbs
inline Fe fe_sub(const Fe& f, const Fe& g) {
    Fe h;
    h.v[0] = f.v[0] + 0x1fffffffffffb4ULL - g.v[0];
    for (int i = 1; i < 5; ++i) h.v[i] = f.v[i] + 0x1ffffffffffffcULL - g.v[i];
    fe_carry(h);
    return h;
}

inline Fe fe_neg(const Fe& f) { return fe_sub(fe_small(0), f); }

Fe fe_mul(const Fe& f, const Fe& g) {
    const u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
    const u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
    const u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
    u128 r0 = u128(f0) * g0 + u128(f1) * g4_19 + u128(f2) * g3_19 + u128(f3) * g2_19 +
              u128(f4) * g1_19;
    u128 r1 = u128(f0) * g1 + u128(f1) * g0 + u128(f2) * g4_19 + u128(f3) * g3_19 +
              u128(f4) * g2_19;
    u128 r2 = u128(f0) * g2 + u128(f1) * g1 + u128(f2) * g0 + u128(f3) * g4_19 +
              u128(f4) * g3_19;
    u128 r3 = u128(f0) * g3 + u128(f1) * g2 + u128(f2) * g1 + u128(f3) * g0 +
              u128(f4) * g4_19;
    u128 r4 = u128(f0) * g4 + u128(f1) * g3 + u128(f2) * g2 + u128(f3) * g1 +
              u128(f4) * g0;
    Fe h;
    r1 += u64(r0 >> 51); h.v[0] = u64(r0) & kMask51;
    r2 += u64(r1 >> 51); h.v[1] = u64(r1) & kMask51;
    r3 += u64(r2 >> 51); h.v[2] = u64(r2) & kMask51;
    r4 += u64(r3 >> 51); h.v[3] = u64(r3) & kMask51;
    u64 c = u64(r4 >> 51);
    h.v[4] = u64(r4) & kMask51;
    h.v[0] += 19 * c;
    h.v[1] += h.v[0] >> 51;
    h.v[0] &= kMask51;
    return h;
}

inline Fe fe_sq(const Fe& f) { return fe_mul(f, f); }

inline Fe fe_sqn(Fe f, int n) {
    while (n--) f = fe_sq(f);
    return f;
}

Fe fe_mul_small(const Fe& f, u64 k) {
    u128 r[5];
    for (int i = 0; i < 5; ++i) r[i] = u128(f.v[i]) * k;
    Fe h;
    for (int i = 0; i < 4; ++i) {
        r[i + 1] += u64(r[i] >> 51);
        h.v[i] = u64(r[i]) & kMask51;
    }
    u64 c = u64(r[4] >> 51);
    h.v[4] = u64(r[4]) & kMask51;
    h.v[0] += 19 * c;
    h.v[1] += h.v[0] >> 51;
    h.v[0] &= kMask51;
    return h;
}

// the bit 255 of s is ignored, as libsodium does; values >= p stay unreduced
Fe fe_frombytes(const u8 s[32]) {
    u64 w0 = load64(s), w1 = load64(s + 8), w2 = load64(s + 16), w3 = load64(s + 24);
    Fe h;
    h.v[0] = w0 & kMask51;
    h.v[1] = ((w0 >> 51) | (w1 << 13)) & kMask51;
    h.v[2] = ((w1 >> 38) | (w2 << 26)) & kMask51;
    h.v[3] = ((w2 >> 25) | (w3 << 39)) & kMask51;
    h.v[4] = (w3 >> 12) & kMask51;
    return h;
}

// the canonical encoding, in [0, p)
void fe_tobytes(u8 s[32], Fe h) {
    fe_carry(h);
    fe_carry(h);  // now h < 2^255 + 19 * 2^13, limbs below 2^51 + small
    u64 q = (h.v[0] + 19) >> 51;
    q = (h.v[1] + q) >> 51;
    q = (h.v[2] + q) >> 51;
    q = (h.v[3] + q) >> 51;
    q = (h.v[4] + q) >> 51;  // 1 exactly when h >= p
    h.v[0] += 19 * q;
    h.v[1] += h.v[0] >> 51; h.v[0] &= kMask51;
    h.v[2] += h.v[1] >> 51; h.v[1] &= kMask51;
    h.v[3] += h.v[2] >> 51; h.v[2] &= kMask51;
    h.v[4] += h.v[3] >> 51; h.v[3] &= kMask51;
    h.v[4] &= kMask51;  // drops the 2^255 of h - p + 2^255
    store64(s, h.v[0] | (h.v[1] << 51));
    store64(s + 8, (h.v[1] >> 13) | (h.v[2] << 38));
    store64(s + 16, (h.v[2] >> 26) | (h.v[3] << 25));
    store64(s + 24, (h.v[3] >> 39) | (h.v[4] << 12));
}

inline int fe_isnegative(const Fe& f) {
    u8 s[32];
    fe_tobytes(s, f);
    return s[0] & 1;
}

inline int fe_iszero(const Fe& f) {
    u8 s[32];
    fe_tobytes(s, f);
    u8 d = 0;
    for (int i = 0; i < 32; ++i) d |= s[i];
    return int(1 & ((u32(d) - 1) >> 8));
}

// swap f and g when bit is 1, with no branch on it
inline void fe_cswap(Fe& f, Fe& g, u64 bit) {
    u64 mask = 0 - bit;
    for (int i = 0; i < 5; ++i) {
        u64 x = mask & (f.v[i] ^ g.v[i]);
        f.v[i] ^= x;
        g.v[i] ^= x;
    }
}

// f = g when bit is 1, with no branch on it
inline void fe_cmov(Fe& f, const Fe& g, u64 bit) {
    u64 mask = 0 - bit;
    for (int i = 0; i < 5; ++i) f.v[i] ^= mask & (f.v[i] ^ g.v[i]);
}

// z^(2^250 - 1) and z^11, the common head of the two exponentiations
void fe_pow_head(const Fe& z, Fe& z_250_1, Fe& z11) {
    Fe z2 = fe_sq(z);
    Fe z9 = fe_mul(fe_sqn(z2, 2), z);
    z11 = fe_mul(z9, z2);
    Fe z_5_1 = fe_mul(fe_sq(z11), z9);                  // 2^5 - 1
    Fe z_10_1 = fe_mul(fe_sqn(z_5_1, 5), z_5_1);        // 2^10 - 1
    Fe z_20_1 = fe_mul(fe_sqn(z_10_1, 10), z_10_1);     // 2^20 - 1
    Fe z_40_1 = fe_mul(fe_sqn(z_20_1, 20), z_20_1);     // 2^40 - 1
    Fe z_50_1 = fe_mul(fe_sqn(z_40_1, 10), z_10_1);     // 2^50 - 1
    Fe z_100_1 = fe_mul(fe_sqn(z_50_1, 50), z_50_1);    // 2^100 - 1
    Fe z_200_1 = fe_mul(fe_sqn(z_100_1, 100), z_100_1); // 2^200 - 1
    z_250_1 = fe_mul(fe_sqn(z_200_1, 50), z_50_1);      // 2^250 - 1
}

// z^(p - 2) = z^(2^255 - 21), the inverse (0 for 0)
Fe fe_invert(const Fe& z) {
    Fe t, z11;
    fe_pow_head(z, t, z11);
    return fe_mul(fe_sqn(t, 5), z11);
}

// z^((p - 5) / 8) = z^(2^252 - 3)
Fe fe_pow22523(const Fe& z) {
    Fe t, z11;
    fe_pow_head(z, t, z11);
    return fe_mul(fe_sqn(t, 2), z);
}

// ------------------------------------------------------------- X25519

// RFC 7748's Montgomery ladder on a clamped scalar; -1 when the shared
// secret is all zeros (a point of small order), as crypto_scalarmult does
int x25519(u8 out[32], const u8 scalar[32], const u8 point[32]) {
    u8 e[32];
    memcpy(e, scalar, 32);
    e[0] &= 248;
    e[31] &= 127;
    e[31] |= 64;
    Fe x1 = fe_frombytes(point);
    Fe x2 = fe_small(1), z2 = fe_small(0), x3 = x1, z3 = fe_small(1);
    u64 swap = 0;
    for (int t = 254; t >= 0; --t) {
        u64 bit = (e[t >> 3] >> (t & 7)) & 1;
        swap ^= bit;
        fe_cswap(x2, x3, swap);
        fe_cswap(z2, z3, swap);
        swap = bit;
        Fe a = fe_add(x2, z2), aa = fe_sq(a);
        Fe b = fe_sub(x2, z2), bb = fe_sq(b);
        Fe en = fe_sub(aa, bb);
        Fe c = fe_add(x3, z3), d = fe_sub(x3, z3);
        Fe da = fe_mul(d, a), cb = fe_mul(c, b);
        x3 = fe_sq(fe_add(da, cb));
        z3 = fe_mul(x1, fe_sq(fe_sub(da, cb)));
        x2 = fe_mul(aa, bb);
        z2 = fe_mul(en, fe_add(aa, fe_mul_small(en, 121665)));
    }
    fe_cswap(x2, x3, swap);
    fe_cswap(z2, z3, swap);
    fe_tobytes(out, fe_mul(x2, fe_invert(z2)));
    wipe(e, sizeof e);
    wipe(&x2, sizeof x2);
    wipe(&z2, sizeof z2);
    wipe(&x3, sizeof x3);
    wipe(&z3, sizeof z3);
    u8 d = 0;
    for (int i = 0; i < 32; ++i) d |= out[i];
    return -int(1 & ((u32(d) - 1) >> 8));
}

int x25519_base(u8 out[32], const u8 scalar[32]) {
    u8 nine[32] = {9};
    return x25519(out, scalar, nine);
}

// ------------------------------------------------------------ the box

// crypto_box_beforenm: HSalsa20 of the X25519 shared secret
int box_beforenm(u8 k[32], const u8 pk[32], const u8 sk[32]) {
    static const u8 zero[16] = {0};
    u8 s[32];
    if (x25519(s, sk, pk) != 0) return -1;
    hsalsa20(k, zero, s);
    wipe(s, sizeof s);
    return 0;
}

// crypto_secretbox_easy: c = MAC (16) || XSalsa20(m), the Poly1305 key the
// first 32 bytes of the keystream, the message XORed from byte 32 on
void secretbox(u8* c, const u8* m, size_t mlen, const u8 n[24], const u8 k[32]) {
    u8 subkey[32], block0[64] = {0};
    hsalsa20(subkey, n, k);
    size_t head = mlen < 32 ? mlen : 32;
    memcpy(block0 + 32, m, head);
    salsa20_xor(block0, block0, 32 + head, n + 16, 0, subkey);
    Poly1305 mac(block0);
    memcpy(c + 16, block0 + 32, head);
    if (mlen > head) salsa20_xor(c + 16 + head, m + head, mlen - head, n + 16, 1, subkey);
    mac.update(c + 16, mlen);
    mac.final(c);
    wipe(subkey, sizeof subkey);
    wipe(block0, sizeof block0);
}

// crypto_secretbox_open_easy: the MAC is checked before anything is decrypted
int secretbox_open(u8* m, const u8* c, size_t clen, const u8 n[24], const u8 k[32]) {
    if (clen < 16) return -1;
    size_t mlen = clen - 16;
    u8 subkey[32], block0[64] = {0}, tag[16];
    hsalsa20(subkey, n, k);
    salsa20_xor(block0, block0, 32, n + 16, 0, subkey);
    Poly1305 mac(block0);
    mac.update(c + 16, mlen);
    mac.final(tag);
    if (verify_n(tag, c, 16) != 0) {
        wipe(subkey, sizeof subkey);
        wipe(block0, sizeof block0);
        return -1;
    }
    size_t head = mlen < 32 ? mlen : 32;
    memcpy(block0 + 32, c + 16, head);
    salsa20_xor(block0, block0, 32 + head, n + 16, 0, subkey);
    memcpy(m, block0 + 32, head);
    if (mlen > head) salsa20_xor(m + head, c + 16 + head, mlen - head, n + 16, 1, subkey);
    wipe(subkey, sizeof subkey);
    wipe(block0, sizeof block0);
    return 0;
}

void seal_nonce(u8 nonce[24], const u8 epk[32], const u8 pk[32]) {
    u8 both[64];
    memcpy(both, epk, 32);
    memcpy(both + 32, pk, 32);
    blake2b(nonce, 24, both, 64);
}

// --------------------------------------------------- scalars mod L

// L = 2^252 + 27742317777372353535851937790883648493, little-endian words
constexpr u64 kL[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0, 0x1000000000000000ULL};
constexpr u64 kR1[4] = {0xd6ec31748d98951dULL, 0xc6ef5bf4737dcf70ULL, 0xfffffffffffffffeULL,
                        0x0fffffffffffffffULL};  // 2^256 mod L
constexpr u64 kR2[4] = {0xa40611e3449c0f01ULL, 0xd00e1ba768859347ULL, 0xceec73d217f5be65ULL,
                        0x0399411b7c309a3dULL};  // 2^512 mod L
constexpr u64 kLInv = 0xd2b51da312547e1bULL;    // -L^-1 mod 2^64

// r = t - L when t >= L, else t, with no branch on t (t < 2L)
void sc_reduce_once(u64 r[4], const u64 t[5]) {
    u64 d[4];
    u64 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 x = u128(t[i]) - kL[i] - borrow;
        d[i] = u64(x);
        borrow = u64(x >> 64) & 1;
    }
    // t < L exactly when the borrow runs out of the top word
    u64 keep_t = 0 - (u64((u128(t[4]) - borrow) >> 64) & 1);
    for (int i = 0; i < 4; ++i) r[i] = (t[i] & keep_t) | (d[i] & ~keep_t);
}

// Montgomery product a * b / 2^256 mod L, for a * b < 2^256 * L
void sc_montmul(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 c = 0;
        for (int j = 0; j < 4; ++j) {
            c = u128(t[j]) + u128(a[j]) * b[i] + u64(c >> 64);
            t[j] = u64(c);
        }
        c = u128(t[4]) + u64(c >> 64);
        t[4] = u64(c);
        t[5] = u64(c >> 64);
        u64 m = t[0] * kLInv;
        c = u128(t[0]) + u128(m) * kL[0];
        for (int j = 1; j < 4; ++j) {
            c = u128(t[j]) + u128(m) * kL[j] + u64(c >> 64);
            t[j - 1] = u64(c);
        }
        c = u128(t[4]) + u64(c >> 64);
        t[3] = u64(c);
        t[4] = t[5] + u64(c >> 64);
    }
    sc_reduce_once(r, t);
}

// (a + b) mod L for a, b < L
void sc_addmod(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[5];
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
        c = u128(a[i]) + b[i] + u64(c >> 64);
        t[i] = u64(c);
    }
    t[4] = u64(c >> 64);
    sc_reduce_once(r, t);
}

void sc_load(u64 w[4], const u8 s[32]) {
    for (int i = 0; i < 4; ++i) w[i] = load64(s + 8 * i);
}

void sc_store(u8 s[32], const u64 w[4]) {
    for (int i = 0; i < 4; ++i) store64(s + 8 * i, w[i]);
}

// a 64-byte little-endian value mod L: lo + hi * 2^256
void sc_reduce64(u8 out[32], const u8 in[64]) {
    u64 lo[4], hi[4], a[4], b[4], r[4];
    sc_load(lo, in);
    sc_load(hi, in + 32);
    sc_montmul(a, lo, kR1);  // lo * 2^256 / 2^256
    sc_montmul(b, hi, kR2);  // hi * 2^512 / 2^256
    sc_addmod(r, a, b);
    sc_store(out, r);
    wipe(lo, sizeof lo);
    wipe(hi, sizeof hi);
    wipe(a, sizeof a);
    wipe(b, sizeof b);
    wipe(r, sizeof r);
}

// s = (h * a + r) mod L, h and r below L, a any 256-bit value
void sc_muladd(u8 s[32], const u8 h[32], const u8 a[32], const u8 r[32]) {
    u64 hw[4], aw[4], rw[4], t[4], u[4], out[4];
    sc_load(hw, h);
    sc_load(aw, a);
    sc_load(rw, r);
    sc_montmul(t, hw, aw);  // h * a / 2^256
    sc_montmul(u, t, kR2);  // h * a
    sc_addmod(out, u, rw);
    sc_store(s, out);
    wipe(aw, sizeof aw);
    wipe(rw, sizeof rw);
    wipe(t, sizeof t);
    wipe(u, sizeof u);
    wipe(out, sizeof out);
}

// S < L, compared from the top byte down
bool sc_is_canonical(const u8 s[32]) {
    u8 lb[32];
    sc_store(lb, kL);
    for (int i = 31; i >= 0; --i) {
        if (s[i] < lb[i]) return true;
        if (s[i] > lb[i]) return false;
    }
    return false;
}

// ---------------------------------------------------------- edwards25519

// extended coordinates: x = X/Z, y = Y/Z, x * y = T/Z
struct Ge {
    Fe X, Y, Z, T;
};
// an addend prepared for addition: Y + X, Y - X, 2d T, 2 Z
struct GeCached {
    Fe YpX, YmX, T2d, Z2;
};

constexpr Ge kBase = {
    {{0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL, 0x1ff60527118feULL,
      0x216936d3cd6e5ULL}},
    {{0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL, 0x3333333333333ULL,
      0x6666666666666ULL}},
    {{1, 0, 0, 0, 0}},
    {{0x68ab3a5b7dda3ULL, 0x00eea2a5eadbbULL, 0x2af8df483c27eULL, 0x332b375274732ULL,
      0x67875f0fd78b7ULL}},
};

inline Ge ge_identity() { return Ge{fe_small(0), fe_small(1), fe_small(1), fe_small(0)}; }

inline GeCached ge_cache(const Ge& p) {
    return GeCached{fe_add(p.Y, p.X), fe_sub(p.Y, p.X), fe_mul(p.T, kFeD2), fe_add(p.Z, p.Z)};
}

// the complete addition of twisted Edwards curves with a = -1 (add-2008-hwcd-3)
Ge ge_add(const Ge& p, const GeCached& q) {
    Fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
    Fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
    Fe c = fe_mul(p.T, q.T2d);
    Fe d = fe_mul(p.Z, q.Z2);
    Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
    return Ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// doubling with a = -1 (dbl-2008-hwcd)
Ge ge_double(const Ge& p) {
    Fe a = fe_sq(p.X);
    Fe b = fe_sq(p.Y);
    Fe c = fe_add(fe_sq(p.Z), fe_sq(p.Z));
    Fe h = fe_add(a, b);                  // -(D - B) with D = -A
    Fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));  // -E
    Fe g = fe_sub(a, b);                  // -(D + B)
    Fe f = fe_add(c, g);                  // -(G - C)
    // (-E)(-F) = EF, (-G)(-H) = GH, (-E)(-H) = EH, (-F)(-G) = FG
    return Ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

void ge_tobytes(u8 s[32], const Ge& p) {
    Fe zi = fe_invert(p.Z);
    Fe x = fe_mul(p.X, zi), y = fe_mul(p.Y, zi);
    fe_tobytes(s, y);
    s[31] ^= u8(fe_isnegative(x) << 7);
}

// -A from its encoding (ge25519_frombytes_negate_vartime); false when the
// encoding is not a point
bool ge_frombytes_negate(Ge& h, const u8 s[32]) {
    h.Y = fe_frombytes(s);
    h.Z = fe_small(1);
    Fe u = fe_sq(h.Y);
    Fe v = fe_mul(u, kFeD);
    u = fe_sub(u, h.Z);  // y^2 - 1
    v = fe_add(v, h.Z);  // d y^2 + 1
    Fe v3 = fe_mul(fe_sq(v), v);
    Fe x = fe_mul(fe_mul(fe_sq(v3), v), u);  // u v^7
    x = fe_pow22523(x);
    x = fe_mul(fe_mul(x, v3), u);  // u v^3 (u v^7)^((p - 5) / 8)
    Fe vxx = fe_mul(fe_sq(x), v);
    if (!fe_iszero(fe_sub(vxx, u))) {
        if (!fe_iszero(fe_add(vxx, u))) return false;
        x = fe_mul(x, kFeSqrtM1);
    }
    if (fe_isnegative(x) == (s[31] >> 7)) x = fe_neg(x);
    h.X = x;
    h.T = fe_mul(h.X, h.Y);
    return true;
}

// [a]B with a 4-bit fixed window; the table lookup reads every entry
void ge_scalarmult_base(Ge& r, const u8 a[32]) {
    GeCached table[16];
    Ge multiple = ge_identity();
    GeCached base = ge_cache(kBase);
    for (int j = 0; j < 16; ++j) {
        table[j] = ge_cache(multiple);
        multiple = ge_add(multiple, base);
    }
    r = ge_identity();
    for (int i = 63; i >= 0; --i) {
        for (int k = 0; k < 4; ++k) r = ge_double(r);
        u32 nibble = (a[i >> 1] >> ((i & 1) * 4)) & 15;
        GeCached pick = table[0];
        for (u32 j = 1; j < 16; ++j) {
            u64 hit = u64((((nibble ^ j) - 1) >> 31) & 1);
            fe_cmov(pick.YpX, table[j].YpX, hit);
            fe_cmov(pick.YmX, table[j].YmX, hit);
            fe_cmov(pick.T2d, table[j].T2d, hit);
            fe_cmov(pick.Z2, table[j].Z2, hit);
        }
        r = ge_add(r, pick);
    }
    wipe(table, sizeof table);
}

// [a]A + [b]B in variable time, for verification only
Ge ge_double_scalarmult_vartime(const u8 a[32], const Ge& A, const u8 b[32]) {
    GeCached ta[16], tb[16];
    Ge ma = ge_identity(), mb = ge_identity();
    GeCached ca = ge_cache(A), cb = ge_cache(kBase);
    for (int j = 0; j < 16; ++j) {
        ta[j] = ge_cache(ma);
        tb[j] = ge_cache(mb);
        ma = ge_add(ma, ca);
        mb = ge_add(mb, cb);
    }
    Ge r = ge_identity();
    for (int i = 63; i >= 0; --i) {
        for (int k = 0; k < 4; ++k) r = ge_double(r);
        int na = (a[i >> 1] >> ((i & 1) * 4)) & 15;
        int nb = (b[i >> 1] >> ((i & 1) * 4)) & 15;
        if (na) r = ge_add(r, ta[na]);
        if (nb) r = ge_add(r, tb[nb]);
    }
    return r;
}

// the encodings of points of small order, sign bit aside
// (ge25519_has_small_order): 0, 1, the two y of order 8, p - 1, p and p + 1
bool has_small_order(const u8 s[32]) {
    static const u8 blocklist[7][32] = {
        {0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
         0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
         0x00, 0x00},
        {0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
         0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
         0x00, 0x00},
        {0x26, 0xe8, 0x95, 0x8f, 0xc2, 0xb2, 0x27, 0xb0, 0x45, 0xc3, 0xf4, 0x89, 0xf2, 0xef, 0x98,
         0xf0, 0xd5, 0xdf, 0xac, 0x05, 0xd3, 0xc6, 0x33, 0x39, 0xb1, 0x38, 0x02, 0x88, 0x6d, 0x53,
         0xfc, 0x05},
        {0xc7, 0x17, 0x6a, 0x70, 0x3d, 0x4d, 0xd8, 0x4f, 0xba, 0x3c, 0x0b, 0x76, 0x0d, 0x10, 0x67,
         0x0f, 0x2a, 0x20, 0x53, 0xfa, 0x2c, 0x39, 0xcc, 0xc6, 0x4e, 0xc7, 0xfd, 0x77, 0x92, 0xac,
         0x03, 0x7a},
        {0xec, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0x7f},
        {0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0x7f},
        {0xee, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0x7f},
    };
    for (const auto& bad : blocklist) {
        if (memcmp(s, bad, 31) == 0 && (s[31] & 0x7f) == bad[31]) return true;
    }
    return false;
}

// y < p, sign bit aside (ge25519_is_canonical)
bool ge_is_canonical(const u8 s[32]) {
    if ((s[31] & 0x7f) != 0x7f) return true;
    for (int i = 30; i > 0; --i) {
        if (s[i] != 0xff) return true;
    }
    return s[0] < 0xed;
}

void sign_seed_keypair(u8 pk[32], u8 sk[64], const u8 seed[32]) {
    u8 az[64];
    Sha512 hs;
    hs.update(seed, 32);
    hs.final(az);
    az[0] &= 248;
    az[31] &= 127;
    az[31] |= 64;
    Ge A;
    ge_scalarmult_base(A, az);
    ge_tobytes(pk, A);
    memmove(sk, seed, 32);
    memmove(sk + 32, pk, 32);
    wipe(az, sizeof az);
    wipe(&A, sizeof A);
}

}  // namespace

extern "C" {

// X25519 of a scalar and a point, and of a scalar and the base point 9;
// -1 when the result is all zeros
int sda_x25519(uint8_t* q, const uint8_t* n, const uint8_t* p) { return x25519(q, n, p); }

int sda_x25519_base(uint8_t* q, const uint8_t* n) { return x25519_base(q, n); }

// a fresh box keypair (crypto_box_keypair); -1 when getrandom fails
int sda_box_keypair(uint8_t* pk, uint8_t* sk) {
    if (random_fill(sk, 32) != 0) return -1;
    return x25519_base(pk, sk);
}

// crypto_box_seal into c (mlen + 48 bytes): with esk null a fresh ephemeral
// key, else the given one. -1 when getrandom fails or pk has small order
int sda_box_seal(uint8_t* c, const uint8_t* m, uint64_t mlen, const uint8_t* pk,
                 const uint8_t* esk) {
    u8 sk[32], k[32], nonce[24];
    if (esk != nullptr) {
        memcpy(sk, esk, 32);
    } else if (random_fill(sk, 32) != 0) {
        return -1;
    }
    int rc = x25519_base(c, sk);  // c starts with epk
    if (rc == 0) rc = box_beforenm(k, pk, sk);
    if (rc == 0) {
        seal_nonce(nonce, c, pk);
        secretbox(c + 32, m, size_t(mlen), nonce, k);
    }
    wipe(sk, sizeof sk);
    wipe(k, sizeof k);
    return rc;
}

// crypto_box_seal_open of c (clen bytes) into m (clen - 48 bytes); -1 when
// the box is short, its epk has small order or its MAC does not verify
int sda_box_seal_open(uint8_t* m, const uint8_t* c, uint64_t clen, const uint8_t* pk,
                      const uint8_t* sk) {
    if (clen < 48) return -1;
    u8 k[32], nonce[24];
    if (box_beforenm(k, c, sk) != 0) return -1;
    seal_nonce(nonce, c, pk);
    int rc = secretbox_open(m, c + 32, size_t(clen - 32), nonce, k);
    wipe(k, sizeof k);
    return rc;
}

// crypto_sign_seed_keypair: sk = seed || pk
int sda_sign_seed_keypair(uint8_t* pk, uint8_t* sk, const uint8_t* seed) {
    sign_seed_keypair(pk, sk, seed);
    return 0;
}

// crypto_sign_keypair over a fresh seed; -1 when getrandom fails
int sda_sign_keypair(uint8_t* pk, uint8_t* sk) {
    u8 seed[32];
    if (random_fill(seed, 32) != 0) return -1;
    sign_seed_keypair(pk, sk, seed);
    wipe(seed, sizeof seed);
    return 0;
}

// crypto_sign_detached: R || S, deterministic (RFC 8032), the public key
// taken from sk[32:64] as libsodium takes it
int sda_sign_detached(uint8_t* sig, const uint8_t* m, uint64_t mlen, const uint8_t* sk) {
    u8 az[64], nonce[64], hram[64];
    {
        Sha512 hs;
        hs.update(sk, 32);
        hs.final(az);
    }
    {
        Sha512 hs;
        hs.update(az + 32, 32);
        hs.update(m, size_t(mlen));
        hs.final(nonce);
    }
    memmove(sig + 32, sk + 32, 32);
    sc_reduce64(nonce, nonce);
    Ge R;
    ge_scalarmult_base(R, nonce);
    ge_tobytes(sig, R);
    {
        Sha512 hs;
        hs.update(sig, 64);
        hs.update(m, size_t(mlen));
        hs.final(hram);
    }
    sc_reduce64(hram, hram);
    az[0] &= 248;
    az[31] &= 127;
    az[31] |= 64;
    sc_muladd(sig + 32, hram, az, nonce);
    wipe(az, sizeof az);
    wipe(nonce, sizeof nonce);
    wipe(&R, sizeof R);
    return 0;
}

// crypto_sign_verify_detached: 0 when sig is a valid signature of m by pk
int sda_sign_verify_detached(const uint8_t* sig, const uint8_t* m, uint64_t mlen,
                             const uint8_t* pk) {
    if (!sc_is_canonical(sig + 32) || has_small_order(sig)) return -1;
    if (!ge_is_canonical(pk) || has_small_order(pk)) return -1;
    Ge A;
    if (!ge_frombytes_negate(A, pk)) return -1;
    u8 h[64], rcheck[32];
    Sha512 hs;
    hs.update(sig, 32);
    hs.update(pk, 32);
    hs.update(m, size_t(mlen));
    hs.final(h);
    sc_reduce64(h, h);
    ge_tobytes(rcheck, ge_double_scalarmult_vartime(h, A, sig + 32));
    return verify_n(rcheck, sig, 32);
}

}  // extern "C"

/* ChaCha20 (RFC 8439 section 2.4) and the ChaCha20-Poly1305 AEAD
 * (section 2.8), for BOLT #8's transport and the onion streams.
 *
 * A connection encrypts every Lightning message twice (its 2-byte length,
 * then its body), so a gossip sync pushes megabytes through here; the
 * plain-Python version in crypto/chachapoly.py is the tests' oracle.
 *
 * Exposes plain C symbols for ctypes; no Python.h dependency.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline uint32_t rotl32(uint32_t v, int c) {
    return (v << c) | (v >> (32 - c));
}

static inline uint32_t load32_le(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
           (uint32_t)p[3] << 24;
}

static inline void store32_le(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
}

static inline uint64_t load64_le(const uint8_t *p) {
    return (uint64_t)load32_le(p) | (uint64_t)load32_le(p + 4) << 32;
}

static inline void store64_le(uint8_t *p, uint64_t v) {
    store32_le(p, (uint32_t)v);
    store32_le(p + 4, (uint32_t)(v >> 32));
}

#define QR(a, b, c, d)                      \
    a += b; d ^= a; d = rotl32(d, 16);      \
    c += d; b ^= c; b = rotl32(b, 12);      \
    a += b; d ^= a; d = rotl32(d, 8);       \
    c += d; b ^= c; b = rotl32(b, 7);

/* One 64-byte keystream block of the state (section 2.3). */
static void chacha20_block(const uint32_t in[16], uint8_t out[64]) {
    uint32_t x[16];
    memcpy(x, in, sizeof(x));
    for (int i = 0; i < 10; i++) {
        QR(x[0], x[4], x[8], x[12]);
        QR(x[1], x[5], x[9], x[13]);
        QR(x[2], x[6], x[10], x[14]);
        QR(x[3], x[7], x[11], x[15]);
        QR(x[0], x[5], x[10], x[15]);
        QR(x[1], x[6], x[11], x[12]);
        QR(x[2], x[7], x[8], x[13]);
        QR(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; i++)
        store32_le(out + 4 * i, x[i] + in[i]);
}

/* The state's words 12-15 are the 16 bytes `iv` as little-endian words:
 * a 32-bit block counter, then the 96-bit nonce.  The counter carries
 * into word 13, as OpenSSL's 16-byte-IV ChaCha20 does. */
static void chacha20_init(uint32_t st[16], const uint8_t key[32],
                          const uint8_t iv[16]) {
    st[0] = 0x61707865u;
    st[1] = 0x3320646eu;
    st[2] = 0x79622d32u;
    st[3] = 0x6b206574u;
    for (int i = 0; i < 8; i++)
        st[4 + i] = load32_le(key + 4 * i);
    for (int i = 0; i < 4; i++)
        st[12 + i] = load32_le(iv + 4 * i);
}

static void chacha20_run(uint32_t st[16], const uint8_t *in, uint8_t *out,
                         size_t n) {
    uint8_t ks[64];
    while (n) {
        size_t m = n < 64 ? n : 64;
        chacha20_block(st, ks);
        if (++st[12] == 0)
            st[13]++;
        if (in) {
            for (size_t i = 0; i < m; i++)
                out[i] = in[i] ^ ks[i];
            in += m;
        } else {
            memcpy(out, ks, m);
        }
        out += m;
        n -= m;
    }
}

/* n bytes of keystream (in == NULL) or in XOR keystream, from the 16-byte
 * counter-and-nonce `iv`. */
void chacha20_xor16(const uint8_t key[32], const uint8_t iv[16],
                    const uint8_t *in, uint8_t *out, size_t n) {
    uint32_t st[16];
    chacha20_init(st, key, iv);
    chacha20_run(st, in, out, n);
}

/* Poly1305 (section 2.5) in 44-bit limbs with 128-bit products. */
typedef struct {
    uint64_t r[3], h[3], pad[2];
    uint8_t buf[16];
    size_t used;
} poly1305;

static void poly_init(poly1305 *p, const uint8_t key[32]) {
    uint64_t t0 = load64_le(key), t1 = load64_le(key + 8);
    p->r[0] = t0 & 0xffc0fffffffULL;
    p->r[1] = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
    p->r[2] = (t1 >> 24) & 0x00ffffffc0fULL;
    p->h[0] = p->h[1] = p->h[2] = 0;
    p->pad[0] = load64_le(key + 16);
    p->pad[1] = load64_le(key + 24);
    p->used = 0;
}

static void poly_blocks(poly1305 *p, const uint8_t *m, size_t n,
                        uint64_t hibit) {
    const uint64_t r0 = p->r[0], r1 = p->r[1], r2 = p->r[2];
    const uint64_t s1 = r1 * (5 << 2), s2 = r2 * (5 << 2);
    uint64_t h0 = p->h[0], h1 = p->h[1], h2 = p->h[2];
    while (n >= 16) {
        uint64_t t0 = load64_le(m), t1 = load64_le(m + 8);
        h0 += t0 & 0xfffffffffffULL;
        h1 += ((t0 >> 44) | (t1 << 20)) & 0xfffffffffffULL;
        h2 += ((t1 >> 24) & 0x3ffffffffffULL) | hibit;
        unsigned __int128 d0 = (unsigned __int128)h0 * r0 +
                               (unsigned __int128)h1 * s2 +
                               (unsigned __int128)h2 * s1;
        unsigned __int128 d1 = (unsigned __int128)h0 * r1 +
                               (unsigned __int128)h1 * r0 +
                               (unsigned __int128)h2 * s2;
        unsigned __int128 d2 = (unsigned __int128)h0 * r2 +
                               (unsigned __int128)h1 * r1 +
                               (unsigned __int128)h2 * r0;
        uint64_t c = (uint64_t)(d0 >> 44);
        h0 = (uint64_t)d0 & 0xfffffffffffULL;
        d1 += c;
        c = (uint64_t)(d1 >> 44);
        h1 = (uint64_t)d1 & 0xfffffffffffULL;
        d2 += c;
        c = (uint64_t)(d2 >> 42);
        h2 = (uint64_t)d2 & 0x3ffffffffffULL;
        h0 += c * 5;
        c = h0 >> 44;
        h0 &= 0xfffffffffffULL;
        h1 += c;
        m += 16;
        n -= 16;
    }
    p->h[0] = h0;
    p->h[1] = h1;
    p->h[2] = h2;
}

static void poly_update(poly1305 *p, const uint8_t *m, size_t n) {
    if (p->used) {
        size_t want = 16 - p->used;
        if (want > n)
            want = n;
        memcpy(p->buf + p->used, m, want);
        p->used += want;
        m += want;
        n -= want;
        if (p->used < 16)
            return;
        poly_blocks(p, p->buf, 16, 1ULL << 40);
        p->used = 0;
    }
    size_t whole = n & ~(size_t)15;
    if (whole) {
        poly_blocks(p, m, whole, 1ULL << 40);
        m += whole;
        n -= whole;
    }
    if (n) {
        memcpy(p->buf, m, n);
        p->used = n;
    }
}

/* The AEAD pads the AD and the ciphertext to 16 bytes with zeros. */
static void poly_pad16(poly1305 *p) {
    static const uint8_t zeros[16] = {0};
    if (p->used)
        poly_update(p, zeros, 16 - p->used);
}

static void poly_finish(poly1305 *p, uint8_t tag[16]) {
    uint64_t h0 = p->h[0], h1 = p->h[1], h2 = p->h[2], c;
    c = h1 >> 44; h1 &= 0xfffffffffffULL;
    h2 += c; c = h2 >> 42; h2 &= 0x3ffffffffffULL;
    h0 += c * 5; c = h0 >> 44; h0 &= 0xfffffffffffULL;
    h1 += c; c = h1 >> 44; h1 &= 0xfffffffffffULL;
    h2 += c; c = h2 >> 42; h2 &= 0x3ffffffffffULL;
    h0 += c * 5; c = h0 >> 44; h0 &= 0xfffffffffffULL;
    h1 += c;
    /* h - p = h + 5 - 2^130: take it if it does not go negative */
    uint64_t g0 = h0 + 5; c = g0 >> 44; g0 &= 0xfffffffffffULL;
    uint64_t g1 = h1 + c; c = g1 >> 44; g1 &= 0xfffffffffffULL;
    uint64_t g2 = h2 + c - (1ULL << 42);
    c = (g2 >> 63) - 1; /* all ones when h >= p */
    h0 = (h0 & ~c) | (g0 & c);
    h1 = (h1 & ~c) | (g1 & c);
    h2 = (h2 & ~c) | (g2 & c);
    /* h + s mod 2^128 */
    uint64_t t0 = p->pad[0], t1 = p->pad[1];
    h0 += t0 & 0xfffffffffffULL; c = h0 >> 44; h0 &= 0xfffffffffffULL;
    h1 += (((t0 >> 44) | (t1 << 20)) & 0xfffffffffffULL) + c;
    c = h1 >> 44; h1 &= 0xfffffffffffULL;
    h2 += ((t1 >> 24) & 0x3ffffffffffULL) + c;
    h2 &= 0x3ffffffffffULL;
    store64_le(tag, h0 | h1 << 44);
    store64_le(tag + 8, (h1 >> 20) | h2 << 24);
}

static void aead_tag(const uint8_t otk[32], const uint8_t *ad, size_t adlen,
                     const uint8_t *ct, size_t ctlen, uint8_t tag[16]) {
    poly1305 p;
    uint8_t lens[16];
    poly_init(&p, otk);
    poly_update(&p, ad, adlen);
    poly_pad16(&p);
    poly_update(&p, ct, ctlen);
    poly_pad16(&p);
    store64_le(lens, (uint64_t)adlen);
    store64_le(lens + 8, (uint64_t)ctlen);
    poly_update(&p, lens, 16);
    poly_finish(&p, tag);
}

/* Block 0 of the stream is the Poly1305 one-time key; the message is
 * XORed from block 1 on (section 2.8). */
static void aead_start(uint32_t st[16], const uint8_t key[32],
                       const uint8_t nonce[12], uint8_t otk[32]) {
    uint8_t iv[16] = {0}, block[64];
    memcpy(iv + 4, nonce, 12);
    chacha20_init(st, key, iv);
    chacha20_block(st, block);
    memcpy(otk, block, 32);
    st[12] = 1;
}

/* out = ciphertext || tag: n + 16 bytes. */
void chachapoly_encrypt(const uint8_t key[32], const uint8_t nonce[12],
                        const uint8_t *ad, size_t adlen, const uint8_t *pt,
                        size_t n, uint8_t *out) {
    uint32_t st[16];
    uint8_t otk[32];
    aead_start(st, key, nonce, otk);
    chacha20_run(st, pt, out, n);
    aead_tag(otk, ad, adlen, out, n, out + n);
}

/* ct holds n bytes of ciphertext and its 16-byte tag; out gets n bytes.
 * Returns 0, or -1 (out untouched) when the tag does not match. */
int chachapoly_decrypt(const uint8_t key[32], const uint8_t nonce[12],
                       const uint8_t *ad, size_t adlen, const uint8_t *ct,
                       size_t n, uint8_t *out) {
    uint32_t st[16];
    uint8_t otk[32], tag[16], diff = 0;
    aead_start(st, key, nonce, otk);
    aead_tag(otk, ad, adlen, ct, n, tag);
    for (int i = 0; i < 16; i++)
        diff |= tag[i] ^ ct[n + i];
    if (diff)
        return -1;
    chacha20_run(st, ct, out, n);
    return 0;
}

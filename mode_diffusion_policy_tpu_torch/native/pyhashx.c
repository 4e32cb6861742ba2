/* pyhashx: the non-cryptographic hashes of the pyhash package, in plain C
 * with a ctypes interface (the port's copy of the JAX package's native
 * extension, without Python.h).
 *
 * Every algorithm is written from its public specification: FNV-1/FNV-1a,
 * MurmurHash1/2/2A/64B/3 (Appleby), xxHash32/64 (Collet), SuperFastHash
 * (Hsieh), lookup3 (Jenkins), CityHash v1.0 with its CRC variants, FarmHash
 * (portable variants), SpookyHash V1, MetroHash, MUM v1 and t1ha. The seed
 * is each algorithm's initial state (for FNV the offset basis, so seed 0
 * gives pyhash's default outputs).
 *
 * The Python side (utils/hashing.py) gives the pyhash call semantics:
 * per-algorithm hasher objects, str hashed as UTF-16LE without a BOM,
 * several arguments chained through the seed, 128- and 256-bit values as
 * Python ints. This file exports:
 *
 *   void pyhashx_init(void);           build the CRC-32C table, once
 *   int  pyhashx_spec(int i, const char **name, int *algo,
 *                     int *val_bits, int *seed_bits);
 *                                      the i-th hasher of the pyhash
 *                                      surface; 0 past the last
 *   void pyhashx_hash(int algo, const uint8_t *buf, size_t len,
 *                     const uint64_t seed[4], uint64_t out[4]);
 *                                      one hash; words least significant
 *                                      first
 *
 * Build: cc -O2 -shared -fPIC pyhashx.c -o libpyhashx.so
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Algorithms                                                          */
/* ------------------------------------------------------------------ */

static uint32_t fnv1_32(const uint8_t *p, size_t n, uint32_t h) {
    for (size_t i = 0; i < n; i++) { h *= 16777619u; h ^= p[i]; }
    return h;
}
static uint32_t fnv1a_32(const uint8_t *p, size_t n, uint32_t h) {
    for (size_t i = 0; i < n; i++) { h ^= p[i]; h *= 16777619u; }
    return h;
}
static uint64_t fnv1_64(const uint8_t *p, size_t n, uint64_t h) {
    for (size_t i = 0; i < n; i++) { h *= 1099511628211ULL; h ^= p[i]; }
    return h;
}
static uint64_t fnv1a_64(const uint8_t *p, size_t n, uint64_t h) {
    for (size_t i = 0; i < n; i++) { h ^= p[i]; h *= 1099511628211ULL; }
    return h;
}

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint32_t murmur3_32(const uint8_t *data, size_t len, uint32_t seed) {
    const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
    uint32_t h = seed;
    size_t nblocks = len / 4;
    for (size_t i = 0; i < nblocks; i++) {
        uint32_t k;
        memcpy(&k, data + i * 4, 4);
        k *= c1; k = rotl32(k, 15); k *= c2;
        h ^= k; h = rotl32(h, 13); h = h * 5 + 0xe6546b64u;
    }
    const uint8_t *tail = data + nblocks * 4;
    uint32_t k1 = 0;
    switch (len & 3) {
        case 3: k1 ^= (uint32_t)tail[2] << 16; /* fallthrough */
        case 2: k1 ^= (uint32_t)tail[1] << 8;  /* fallthrough */
        case 1: k1 ^= tail[0];
                k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h ^= k1;
    }
    h ^= (uint32_t)len;
    h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u; h ^= h >> 16;
    return h;
}

#define XXP32_1 2654435761U
#define XXP32_2 2246822519U
#define XXP32_3 3266489917U
#define XXP32_4 668265263U
#define XXP32_5 374761393U

static uint32_t xx_32(const uint8_t *p, size_t len, uint32_t seed) {
    const uint8_t *end = p + len;
    uint32_t h;
    if (len >= 16) {
        const uint8_t *limit = end - 16;
        uint32_t v1 = seed + XXP32_1 + XXP32_2, v2 = seed + XXP32_2,
                 v3 = seed, v4 = seed - XXP32_1;
        do {
            uint32_t k;
            memcpy(&k, p, 4); v1 += k * XXP32_2; v1 = rotl32(v1, 13); v1 *= XXP32_1; p += 4;
            memcpy(&k, p, 4); v2 += k * XXP32_2; v2 = rotl32(v2, 13); v2 *= XXP32_1; p += 4;
            memcpy(&k, p, 4); v3 += k * XXP32_2; v3 = rotl32(v3, 13); v3 *= XXP32_1; p += 4;
            memcpy(&k, p, 4); v4 += k * XXP32_2; v4 = rotl32(v4, 13); v4 *= XXP32_1; p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + XXP32_5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        uint32_t k; memcpy(&k, p, 4);
        h += k * XXP32_3; h = rotl32(h, 17) * XXP32_4; p += 4;
    }
    while (p < end) { h += (*p) * XXP32_5; h = rotl32(h, 11) * XXP32_1; p++; }
    h ^= h >> 15; h *= XXP32_2; h ^= h >> 13; h *= XXP32_3; h ^= h >> 16;
    return h;
}

#define XXP64_1 11400714785074694791ULL
#define XXP64_2 14029467366897019727ULL
#define XXP64_3 1609587929392839161ULL
#define XXP64_4 9650029242287828579ULL
#define XXP64_5 2870177450012600261ULL

static uint64_t xx_round(uint64_t acc, uint64_t input) {
    acc += input * XXP64_2; acc = rotl64(acc, 31); acc *= XXP64_1; return acc;
}
static uint64_t xx_merge(uint64_t acc, uint64_t val) {
    val = xx_round(0, val); acc ^= val; acc = acc * XXP64_1 + XXP64_4; return acc;
}

static uint64_t xx_64(const uint8_t *p, size_t len, uint64_t seed) {
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        const uint8_t *limit = end - 32;
        uint64_t v1 = seed + XXP64_1 + XXP64_2, v2 = seed + XXP64_2,
                 v3 = seed, v4 = seed - XXP64_1;
        do {
            uint64_t k;
            memcpy(&k, p, 8); v1 = xx_round(v1, k); p += 8;
            memcpy(&k, p, 8); v2 = xx_round(v2, k); p += 8;
            memcpy(&k, p, 8); v3 = xx_round(v3, k); p += 8;
            memcpy(&k, p, 8); v4 = xx_round(v4, k); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xx_merge(h, v1); h = xx_merge(h, v2);
        h = xx_merge(h, v3); h = xx_merge(h, v4);
    } else {
        h = seed + XXP64_5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        uint64_t k; memcpy(&k, p, 8);
        h ^= xx_round(0, k); h = rotl64(h, 27) * XXP64_1 + XXP64_4; p += 8;
    }
    if (p + 4 <= end) {
        uint32_t k; memcpy(&k, p, 4);
        h ^= (uint64_t)k * XXP64_1; h = rotl64(h, 23) * XXP64_2 + XXP64_3; p += 4;
    }
    while (p < end) { h ^= (*p) * XXP64_5; h = rotl64(h, 11) * XXP64_1; p++; }
    h ^= h >> 33; h *= XXP64_2; h ^= h >> 29; h *= XXP64_3; h ^= h >> 32;
    return h;
}

static uint32_t super_fast_hash(const uint8_t *data, size_t len, uint32_t seed) {
    uint32_t hash = seed ? seed : (uint32_t)len, tmp;
    if (len == 0 || data == NULL) return 0;
    size_t rem = len & 3;
    len >>= 2;
    for (; len > 0; len--) {
        uint16_t lo, hi;
        memcpy(&lo, data, 2); memcpy(&hi, data + 2, 2);
        hash += lo;
        tmp = ((uint32_t)hi << 11) ^ hash;
        hash = (hash << 16) ^ tmp;
        data += 4;
        hash += hash >> 11;
    }
    switch (rem) {
        case 3: { uint16_t lo; memcpy(&lo, data, 2);
                  hash += lo; hash ^= hash << 16;
                  hash ^= (uint32_t)((int8_t)data[2]) << 18;
                  hash += hash >> 11; break; }
        case 2: { uint16_t lo; memcpy(&lo, data, 2);
                  hash += lo; hash ^= hash << 11; hash += hash >> 17; break; }
        case 1: hash += (int8_t)data[0]; hash ^= hash << 10; hash += hash >> 1;
    }
    hash ^= hash << 3; hash += hash >> 5; hash ^= hash << 4;
    hash += hash >> 17; hash ^= hash << 25; hash += hash >> 6;
    return hash;
}

/* lookup3 (Jenkins) hashlittle */
#define L3_MIX(a,b,c) { \
    a -= c; a ^= rotl32(c, 4);  c += b; \
    b -= a; b ^= rotl32(a, 6);  a += c; \
    c -= b; c ^= rotl32(b, 8);  b += a; \
    a -= c; a ^= rotl32(c,16);  c += b; \
    b -= a; b ^= rotl32(a,19);  a += c; \
    c -= b; c ^= rotl32(b, 4);  b += a; }
#define L3_FINAL(a,b,c) { \
    c ^= b; c -= rotl32(b,14); \
    a ^= c; a -= rotl32(c,11); \
    b ^= a; b -= rotl32(a,25); \
    c ^= b; c -= rotl32(b,16); \
    a ^= c; a -= rotl32(c, 4); \
    b ^= a; b -= rotl32(a,14); \
    c ^= b; c -= rotl32(b,24); }

static uint32_t lookup3_little(const uint8_t *k, size_t length, uint32_t initval) {
    uint32_t a, b, c;
    a = b = c = 0xdeadbeef + ((uint32_t)length) + initval;
    while (length > 12) {
        uint32_t w[3];
        memcpy(w, k, 12);
        a += w[0]; b += w[1]; c += w[2];
        L3_MIX(a, b, c);
        length -= 12; k += 12;
    }
    /* tail — byte-at-a-time little-endian accumulation */
    switch (length) {
        case 12: c += ((uint32_t)k[11]) << 24; /* fallthrough */
        case 11: c += ((uint32_t)k[10]) << 16; /* fallthrough */
        case 10: c += ((uint32_t)k[9]) << 8;   /* fallthrough */
        case 9:  c += k[8];                    /* fallthrough */
        case 8:  b += ((uint32_t)k[7]) << 24;  /* fallthrough */
        case 7:  b += ((uint32_t)k[6]) << 16;  /* fallthrough */
        case 6:  b += ((uint32_t)k[5]) << 8;   /* fallthrough */
        case 5:  b += k[4];                    /* fallthrough */
        case 4:  a += ((uint32_t)k[3]) << 24;  /* fallthrough */
        case 3:  a += ((uint32_t)k[2]) << 16;  /* fallthrough */
        case 2:  a += ((uint32_t)k[1]) << 8;   /* fallthrough */
        case 1:  a += k[0]; break;
        case 0:  return c;
    }
    L3_FINAL(a, b, c);
    return c;
}

/* MurmurHash2 (Appleby) */
static uint32_t murmur2_32(const uint8_t *data, size_t len, uint32_t seed) {
    const uint32_t m = 0x5bd1e995u; const int r = 24;
    uint32_t h = seed ^ (uint32_t)len;
    while (len >= 4) {
        uint32_t k; memcpy(&k, data, 4);
        k *= m; k ^= k >> r; k *= m;
        h *= m; h ^= k;
        data += 4; len -= 4;
    }
    switch (len) {
        case 3: h ^= (uint32_t)data[2] << 16; /* fallthrough */
        case 2: h ^= (uint32_t)data[1] << 8;  /* fallthrough */
        case 1: h ^= data[0]; h *= m;
    }
    h ^= h >> 13; h *= m; h ^= h >> 15;
    return h;
}

/* MurmurHash2 x64 (murmur2_x64_64a) */
static uint64_t murmur2_x64_64a(const uint8_t *data, size_t len, uint64_t seed) {
    const uint64_t m = 0xc6a4a7935bd1e995ULL; const int r = 47;
    uint64_t h = seed ^ (len * m);
    while (len >= 8) {
        uint64_t k; memcpy(&k, data, 8);
        k *= m; k ^= k >> r; k *= m;
        h ^= k; h *= m;
        data += 8; len -= 8;
    }
    switch (len) {
        case 7: h ^= (uint64_t)data[6] << 48; /* fallthrough */
        case 6: h ^= (uint64_t)data[5] << 40; /* fallthrough */
        case 5: h ^= (uint64_t)data[4] << 32; /* fallthrough */
        case 4: h ^= (uint64_t)data[3] << 24; /* fallthrough */
        case 3: h ^= (uint64_t)data[2] << 16; /* fallthrough */
        case 2: h ^= (uint64_t)data[1] << 8;  /* fallthrough */
        case 1: h ^= (uint64_t)data[0]; h *= m;
    }
    h ^= h >> r; h *= m; h ^= h >> r;
    return h;
}

/* ------------------------------------------------------------------ */
/* Shared helpers for the wide-surface algorithms                      */
/* ------------------------------------------------------------------ */

static inline uint32_t ror32(uint32_t x, int r) { return r ? (x >> r) | (x << (32 - r)) : x; }
static inline uint64_t ror64(uint64_t x, int r) { return r ? (x >> r) | (x << (64 - r)) : x; }
static inline uint16_t fetch16(const uint8_t *p) { uint16_t v; memcpy(&v, p, 2); return v; }
static inline uint32_t fetch32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t fetch64(const uint8_t *p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline uint32_t bswap32(uint32_t x) { return __builtin_bswap32(x); }
static inline uint64_t bswap64(uint64_t x) { return __builtin_bswap64(x); }

/* up-to-256-bit hash value, w[0] = least significant 64 bits */
typedef struct { uint64_t w[4]; } hv_t;

/* CRC-32C (Castagnoli, reflected poly 0x82F63B78) — bit-exact software
 * equivalent of the SSE4.2 CRC32 instruction used by CityHashCrc* and the
 * metro*crc* variants (no pre/post inversion, 32-bit state zero-extended). */
static uint32_t crc32c_table[256];
static void crc32c_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        crc32c_table[i] = c;
    }
}
static inline uint32_t crc32c_bytes(uint32_t crc, const uint8_t *p, int n) {
    for (int i = 0; i < n; i++)
        crc = crc32c_table[(crc ^ p[i]) & 0xff] ^ (crc >> 8);
    return crc;
}
/* _mm_crc32_u64(crc, v): uses low 32 bits of crc, folds 8 LE bytes of v */
static inline uint64_t crc32c_u64(uint64_t crc, uint64_t v) {
    uint8_t b[8]; memcpy(b, &v, 8);
    return crc32c_bytes((uint32_t)crc, b, 8);
}
static inline uint64_t crc32c_u32v(uint64_t crc, uint32_t v) {
    uint8_t b[4]; memcpy(b, &v, 4);
    return crc32c_bytes((uint32_t)crc, b, 4);
}
static inline uint64_t crc32c_u16v(uint64_t crc, uint16_t v) {
    uint8_t b[2]; memcpy(b, &v, 2);
    return crc32c_bytes((uint32_t)crc, b, 2);
}
static inline uint64_t crc32c_u8v(uint64_t crc, uint8_t v) {
    return crc32c_bytes((uint32_t)crc, &v, 1);
}

/* ------------------------------------------------------------------ */
/* MurmurHash1 / 2A / 64B / 3-128 (Appleby, public domain)             */
/* ------------------------------------------------------------------ */

static uint32_t murmur1_32(const uint8_t *data, size_t len, uint32_t seed) {
    const uint32_t m = 0xc6a4a793u; const int r = 16;
    uint32_t h = seed ^ ((uint32_t)len * m);
    while (len >= 4) {
        h += fetch32(data); h *= m; h ^= h >> 16;
        data += 4; len -= 4;
    }
    switch (len) {
        case 3: h += (uint32_t)data[2] << 16; /* fallthrough */
        case 2: h += (uint32_t)data[1] << 8;  /* fallthrough */
        case 1: h += data[0]; h *= m; h ^= h >> r;
    }
    h *= m; h ^= h >> 10; h *= m; h ^= h >> 17;
    return h;
}

static uint32_t murmur2a_32(const uint8_t *data, size_t len, uint32_t seed) {
    const uint32_t m = 0x5bd1e995u; const int r = 24;
    uint32_t h = seed, l = (uint32_t)len;
#define MMIX(h, k) { k *= m; k ^= k >> r; k *= m; h *= m; h ^= k; }
    while (len >= 4) {
        uint32_t k = fetch32(data);
        MMIX(h, k);
        data += 4; len -= 4;
    }
    uint32_t t = 0;
    switch (len) {
        case 3: t ^= (uint32_t)data[2] << 16; /* fallthrough */
        case 2: t ^= (uint32_t)data[1] << 8;  /* fallthrough */
        case 1: t ^= data[0];
    }
    MMIX(h, t);
    MMIX(h, l);
#undef MMIX
    h ^= h >> 13; h *= m; h ^= h >> 15;
    return h;
}

/* MurmurHash64B — the 32-bit-platform 64-bit murmur2 */
static uint64_t murmur2_x86_64b(const uint8_t *data, size_t len, uint64_t seed) {
    const uint32_t m = 0x5bd1e995u; const int r = 24;
    uint32_t h1 = (uint32_t)seed ^ (uint32_t)len;
    uint32_t h2 = (uint32_t)(seed >> 32);
    while (len >= 8) {
        uint32_t k1 = fetch32(data);
        k1 *= m; k1 ^= k1 >> r; k1 *= m; h1 *= m; h1 ^= k1;
        data += 4; len -= 4;
        uint32_t k2 = fetch32(data);
        k2 *= m; k2 ^= k2 >> r; k2 *= m; h2 *= m; h2 ^= k2;
        data += 4; len -= 4;
    }
    if (len >= 4) {
        uint32_t k1 = fetch32(data);
        k1 *= m; k1 ^= k1 >> r; k1 *= m; h1 *= m; h1 ^= k1;
        data += 4; len -= 4;
    }
    switch (len) {
        case 3: h2 ^= (uint32_t)data[2] << 16; /* fallthrough */
        case 2: h2 ^= (uint32_t)data[1] << 8;  /* fallthrough */
        case 1: h2 ^= data[0]; h2 *= m;
    }
    h1 ^= h2 >> 18; h1 *= m;
    h2 ^= h1 >> 22; h2 *= m;
    h1 ^= h2 >> 17; h1 *= m;
    h2 ^= h1 >> 19; h2 *= m;
    return ((uint64_t)h1 << 32) | h2;
}

static uint32_t mm3_fmix32(uint32_t h) {
    h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u; h ^= h >> 16;
    return h;
}
static uint64_t mm3_fmix64(uint64_t k) {
    k ^= k >> 33; k *= 0xff51afd7ed558ccdULL; k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL; k ^= k >> 33;
    return k;
}

static hv_t murmur3_x86_128(const uint8_t *data, size_t len, uint32_t seed) {
    const size_t nblocks = len / 16;
    uint32_t h1 = seed, h2 = seed, h3 = seed, h4 = seed;
    const uint32_t c1 = 0x239b961bu, c2 = 0xab0e9789u,
                   c3 = 0x38b34ae5u, c4 = 0xa1e38b93u;
    for (size_t i = 0; i < nblocks; i++) {
        uint32_t k1 = fetch32(data + i * 16);
        uint32_t k2 = fetch32(data + i * 16 + 4);
        uint32_t k3 = fetch32(data + i * 16 + 8);
        uint32_t k4 = fetch32(data + i * 16 + 12);
        k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
        h1 = rotl32(h1, 19); h1 += h2; h1 = h1 * 5 + 0x561ccd1bu;
        k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2;
        h2 = rotl32(h2, 17); h2 += h3; h2 = h2 * 5 + 0x0bcaa747u;
        k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3;
        h3 = rotl32(h3, 15); h3 += h4; h3 = h3 * 5 + 0x96cd1c35u;
        k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4;
        h4 = rotl32(h4, 13); h4 += h1; h4 = h4 * 5 + 0x32ac3b17u;
    }
    const uint8_t *tail = data + nblocks * 16;
    uint32_t k1 = 0, k2 = 0, k3 = 0, k4 = 0;
    switch (len & 15) {
        case 15: k4 ^= (uint32_t)tail[14] << 16; /* fallthrough */
        case 14: k4 ^= (uint32_t)tail[13] << 8;  /* fallthrough */
        case 13: k4 ^= tail[12];
                 k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4; /* fallthrough */
        case 12: k3 ^= (uint32_t)tail[11] << 24; /* fallthrough */
        case 11: k3 ^= (uint32_t)tail[10] << 16; /* fallthrough */
        case 10: k3 ^= (uint32_t)tail[9] << 8;   /* fallthrough */
        case 9:  k3 ^= tail[8];
                 k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3; /* fallthrough */
        case 8:  k2 ^= (uint32_t)tail[7] << 24;  /* fallthrough */
        case 7:  k2 ^= (uint32_t)tail[6] << 16;  /* fallthrough */
        case 6:  k2 ^= (uint32_t)tail[5] << 8;   /* fallthrough */
        case 5:  k2 ^= tail[4];
                 k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2; /* fallthrough */
        case 4:  k1 ^= (uint32_t)tail[3] << 24;  /* fallthrough */
        case 3:  k1 ^= (uint32_t)tail[2] << 16;  /* fallthrough */
        case 2:  k1 ^= (uint32_t)tail[1] << 8;   /* fallthrough */
        case 1:  k1 ^= tail[0];
                 k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint32_t)len; h2 ^= (uint32_t)len; h3 ^= (uint32_t)len; h4 ^= (uint32_t)len;
    h1 += h2; h1 += h3; h1 += h4; h2 += h1; h3 += h1; h4 += h1;
    h1 = mm3_fmix32(h1); h2 = mm3_fmix32(h2); h3 = mm3_fmix32(h3); h4 = mm3_fmix32(h4);
    h1 += h2; h1 += h3; h1 += h4; h2 += h1; h3 += h1; h4 += h1;
    hv_t out = {{((uint64_t)h2 << 32) | h1, ((uint64_t)h4 << 32) | h3, 0, 0}};
    return out;
}

static hv_t murmur3_x64_128(const uint8_t *data, size_t len, uint32_t seed) {
    const size_t nblocks = len / 16;
    uint64_t h1 = seed, h2 = seed;
    const uint64_t c1 = 0x87c37b91114253d5ULL, c2 = 0x4cf5ad432745937fULL;
    for (size_t i = 0; i < nblocks; i++) {
        uint64_t k1 = fetch64(data + i * 16);
        uint64_t k2 = fetch64(data + i * 16 + 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729u;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5u;
    }
    const uint8_t *tail = data + nblocks * 16;
    uint64_t k1 = 0, k2 = 0;
    switch (len & 15) {
        case 15: k2 ^= (uint64_t)tail[14] << 48; /* fallthrough */
        case 14: k2 ^= (uint64_t)tail[13] << 40; /* fallthrough */
        case 13: k2 ^= (uint64_t)tail[12] << 32; /* fallthrough */
        case 12: k2 ^= (uint64_t)tail[11] << 24; /* fallthrough */
        case 11: k2 ^= (uint64_t)tail[10] << 16; /* fallthrough */
        case 10: k2 ^= (uint64_t)tail[9] << 8;   /* fallthrough */
        case 9:  k2 ^= tail[8];
                 k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2; /* fallthrough */
        case 8:  k1 ^= (uint64_t)tail[7] << 56;  /* fallthrough */
        case 7:  k1 ^= (uint64_t)tail[6] << 48;  /* fallthrough */
        case 6:  k1 ^= (uint64_t)tail[5] << 40;  /* fallthrough */
        case 5:  k1 ^= (uint64_t)tail[4] << 32;  /* fallthrough */
        case 4:  k1 ^= (uint64_t)tail[3] << 24;  /* fallthrough */
        case 3:  k1 ^= (uint64_t)tail[2] << 16;  /* fallthrough */
        case 2:  k1 ^= (uint64_t)tail[1] << 8;   /* fallthrough */
        case 1:  k1 ^= tail[0];
                 k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
    h1 += h2; h2 += h1;
    h1 = mm3_fmix64(h1); h2 = mm3_fmix64(h2);
    h1 += h2; h2 += h1;
    hv_t out = {{h1, h2, 0, 0}};
    return out;
}

/* lookup3 hashbig: Jenkins' big-endian variant — on little-endian hosts the
 * words are assembled byte-at-a-time MSB-first (lookup3.c hashbig). */
static uint32_t lookup3_big(const uint8_t *k, size_t length, uint32_t initval) {
    uint32_t a, b, c;
    a = b = c = 0xdeadbeef + ((uint32_t)length) + initval;
    while (length > 12) {
        a += ((uint32_t)k[0]) << 24; a += ((uint32_t)k[1]) << 16;
        a += ((uint32_t)k[2]) << 8;  a += k[3];
        b += ((uint32_t)k[4]) << 24; b += ((uint32_t)k[5]) << 16;
        b += ((uint32_t)k[6]) << 8;  b += k[7];
        c += ((uint32_t)k[8]) << 24; c += ((uint32_t)k[9]) << 16;
        c += ((uint32_t)k[10]) << 8; c += k[11];
        L3_MIX(a, b, c);
        length -= 12; k += 12;
    }
    switch (length) {                  /* MSB-first tail */
        case 12: c += k[11];                   /* fallthrough */
        case 11: c += ((uint32_t)k[10]) << 8;  /* fallthrough */
        case 10: c += ((uint32_t)k[9]) << 16;  /* fallthrough */
        case 9:  c += ((uint32_t)k[8]) << 24;  /* fallthrough */
        case 8:  b += k[7];                    /* fallthrough */
        case 7:  b += ((uint32_t)k[6]) << 8;   /* fallthrough */
        case 6:  b += ((uint32_t)k[5]) << 16;  /* fallthrough */
        case 5:  b += ((uint32_t)k[4]) << 24;  /* fallthrough */
        case 4:  a += k[3];                    /* fallthrough */
        case 3:  a += ((uint32_t)k[2]) << 8;   /* fallthrough */
        case 2:  a += ((uint32_t)k[1]) << 16;  /* fallthrough */
        case 1:  a += ((uint32_t)k[0]) << 24; break;
        case 0:  return c;
    }
    L3_FINAL(a, b, c);
    return c;
}

/* ------------------------------------------------------------------ */
/* CityHash (Pike & Alakuijala) — the v1.0 revision vendored by pyhash
 * (still carries k3 and the RotateByAtLeast1 short hash); 128-bit callers
 * on SSE4.2 hosts route through the CRC-based CityHashCrc* functions, which
 * we reproduce with the software CRC-32C above.                        */
/* ------------------------------------------------------------------ */

#define CITY_K0 0xc3a5c85c97cb3127ULL
#define CITY_K1 0xb492b66fbe98f273ULL
#define CITY_K2 0x9ae16a3b2f90404fULL
#define CITY_K3 0xc949d7c7509e6557ULL
#define CITY_MUL 0x9ddfea08eb382d69ULL

static inline uint64_t city_mix(uint64_t v) { return v ^ (v >> 47); }

static inline uint64_t city_h16(uint64_t u, uint64_t v) {
    uint64_t a = (u ^ v) * CITY_MUL;
    a ^= a >> 47;
    uint64_t b = (v ^ a) * CITY_MUL;
    b ^= b >> 47;
    return b * CITY_MUL;
}

static uint64_t city_len0to16(const uint8_t *s, size_t len) {
    if (len > 8) {
        uint64_t a = fetch64(s), b = fetch64(s + len - 8);
        /* RotateByAtLeast1: shift = len, 9..16 here so never 0 */
        return city_h16(a, ror64(b + len, (int)len)) ^ b;
    }
    if (len >= 4) {
        uint64_t a = fetch32(s);
        return city_h16(len + (a << 3), fetch32(s + len - 4));
    }
    if (len > 0) {
        uint8_t a = s[0], b = s[len >> 1], c = s[len - 1];
        uint32_t y = (uint32_t)a + ((uint32_t)b << 8);
        uint32_t z = (uint32_t)len + ((uint32_t)c << 2);
        return city_mix(y * CITY_K2 ^ z * CITY_K3) * CITY_K2;
    }
    return CITY_K2;
}

static uint64_t city_len17to32(const uint8_t *s, size_t len) {
    uint64_t a = fetch64(s) * CITY_K1;
    uint64_t b = fetch64(s + 8);
    uint64_t c = fetch64(s + len - 8) * CITY_K2;
    uint64_t d = fetch64(s + len - 16) * CITY_K0;
    return city_h16(ror64(a - b, 43) + ror64(c, 30) + d,
                    a + ror64(b ^ CITY_K3, 20) - c + len);
}

static void city_weak32(const uint8_t *s, uint64_t a, uint64_t b,
                        uint64_t *out_a, uint64_t *out_b) {
    uint64_t w = fetch64(s), x = fetch64(s + 8), y = fetch64(s + 16),
             z = fetch64(s + 24);
    a += w;
    b = ror64(b + a + z, 21);
    uint64_t c = a;
    a += x; a += y;
    b += ror64(a, 44);
    *out_a = a + z;
    *out_b = b + c;
}

static uint64_t city_len33to64(const uint8_t *s, size_t len) {
    uint64_t z = fetch64(s + 24);
    uint64_t a = fetch64(s) + (len + fetch64(s + len - 16)) * CITY_K0;
    uint64_t b = ror64(a + z, 52);
    uint64_t c = ror64(a, 37);
    a += fetch64(s + 8);
    c += ror64(a, 7);
    a += fetch64(s + 16);
    uint64_t vf = a + z;
    uint64_t vs = b + ror64(a, 31) + c;
    a = fetch64(s + 16) + fetch64(s + len - 32);
    z = fetch64(s + len - 8);
    b = ror64(a + z, 52);
    c = ror64(a, 37);
    a += fetch64(s + len - 24);
    c += ror64(a, 7);
    a += fetch64(s + len - 16);
    uint64_t wf = a + z;
    uint64_t ws = b + ror64(a, 31) + c;
    uint64_t r = city_mix((vf + ws) * CITY_K2 + (wf + vs) * CITY_K0);
    return city_mix(r * CITY_K0 + vs) * CITY_K2;
}

static uint64_t city_64(const uint8_t *s, size_t len) {
    if (len <= 32)
        return len <= 16 ? city_len0to16(s, len) : city_len17to32(s, len);
    if (len <= 64)
        return city_len33to64(s, len);
    uint64_t x = fetch64(s + len - 40);
    uint64_t y = fetch64(s + len - 16) + fetch64(s + len - 56);
    uint64_t z = city_h16(fetch64(s + len - 48) + len, fetch64(s + len - 24));
    uint64_t va, vb, wa, wb;
    city_weak32(s + len - 64, len, z, &va, &vb);
    city_weak32(s + len - 32, y + CITY_K1, x, &wa, &wb);
    x = x * CITY_K1 + fetch64(s);
    len = (len - 1) & ~(size_t)63;
    do {
        x = ror64(x + y + va + fetch64(s + 8), 37) * CITY_K1;
        y = ror64(y + vb + fetch64(s + 48), 42) * CITY_K1;
        x ^= wb;
        y += va + fetch64(s + 40);
        z = ror64(z + wa, 33) * CITY_K1;
        city_weak32(s, vb * CITY_K1, x + wa, &va, &vb);
        city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
        uint64_t t = z; z = x; x = t;
        s += 64;
        len -= 64;
    } while (len != 0);
    return city_h16(city_h16(va, wa) + city_mix(y) * CITY_K1 + z,
                    city_h16(vb, wb) + x);
}

static uint64_t city_64_with_seeds(const uint8_t *s, size_t len,
                                   uint64_t seed0, uint64_t seed1) {
    return city_h16(city_64(s, len) - seed0, seed1);
}

/* 32-bit City (murmur3-flavored), as vendored (City.cpp:144-230) */
static inline uint32_t city_mur(uint32_t a, uint32_t h) {
    a *= 0xcc9e2d51u;
    a = ror32(a, 17);
    a *= 0x1b873593u;
    h ^= a;
    h = ror32(h, 19);
    return h * 5 + 0xe6546b64u;
}

static uint32_t city_32_with_seed(const uint8_t *s, size_t len, uint32_t seed) {
    const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
    if (len <= 4) {
        uint32_t b = seed, c = 9;
        for (size_t i = 0; i < len; i++) {
            b = b * c1 + (uint32_t)(int8_t)s[i];
            c ^= b;
        }
        return mm3_fmix32(city_mur(b, city_mur((uint32_t)len, c)));
    }
    if (len <= 12) {
        uint32_t a = (uint32_t)len + seed, b = (uint32_t)len * 5, c = 9, d = b;
        a += fetch32(s);
        b += fetch32(s + len - 4);
        c += fetch32(s + ((len >> 1) & 4));
        return mm3_fmix32(city_mur(c, city_mur(b, city_mur(a, d))));
    }
    if (len <= 24) {
        uint32_t a = fetch32(s - 4 + (len >> 1));
        uint32_t b = fetch32(s + 4);
        uint32_t c = fetch32(s + len - 8);
        uint32_t d = fetch32(s + (len >> 1));
        uint32_t e = fetch32(s);
        uint32_t f = fetch32(s + len - 4);
        uint32_t h = seed + (uint32_t)len;
        return mm3_fmix32(city_mur(f, city_mur(e, city_mur(d, city_mur(c,
            city_mur(b, city_mur(a, h)))))));
    }
    uint32_t h = (uint32_t)len + seed, g = c1 * (uint32_t)len, f = g;
    uint32_t a0 = ror32(fetch32(s + len - 4) * c1, 17) * c2;
    uint32_t a1 = ror32(fetch32(s + len - 8) * c1, 17) * c2;
    uint32_t a2 = ror32(fetch32(s + len - 16) * c1, 17) * c2;
    uint32_t a3 = ror32(fetch32(s + len - 12) * c1, 17) * c2;
    uint32_t a4 = ror32(fetch32(s + len - 20) * c1, 17) * c2;
    h ^= a0; h = ror32(h, 19); h = h * 5 + 0xe6546b64u;
    h ^= a2; h = ror32(h, 19); h = h * 5 + 0xe6546b64u;
    g ^= a1; g = ror32(g, 19); g = g * 5 + 0xe6546b64u;
    g ^= a3; g = ror32(g, 19); g = g * 5 + 0xe6546b64u;
    f += a4; f = ror32(f, 19); f = f * 5 + 0xe6546b64u;
    size_t iters = (len - 1) / 20;
    do {
        uint32_t b0 = ror32(fetch32(s) * c1, 17) * c2;
        uint32_t b1 = fetch32(s + 4);
        uint32_t b2 = ror32(fetch32(s + 8) * c1, 17) * c2;
        uint32_t b3 = ror32(fetch32(s + 12) * c1, 17) * c2;
        uint32_t b4 = fetch32(s + 16);
        h ^= b0; h = ror32(h, 18); h = h * 5 + 0xe6546b64u;
        f += b1; f = ror32(f, 19); f = f * c1;
        g += b2; g = ror32(g, 18); g = g * 5 + 0xe6546b64u;
        h ^= b3 + b1; h = ror32(h, 19); h = h * 5 + 0xe6546b64u;
        g ^= b4; g = bswap32(g) * 5;
        h += b4 * 5; h = bswap32(h);
        f += b0;
        { uint32_t t = f; f = h; h = t; }   /* PERMUTE3(f,h,g): swap(f,h) */
        { uint32_t t = f; f = g; g = t; }   /* then swap(f,g) */
        s += 20;
    } while (--iters != 0);
    g = ror32(g, 11) * c1;
    g = ror32(g, 17) * c1;
    f = ror32(f, 11) * c1;
    f = ror32(f, 17) * c1;
    h = ror32(h + g, 19); h = h * 5 + 0xe6546b64u; h = ror32(h, 17) * c1;
    h = ror32(h + f, 19); h = h * 5 + 0xe6546b64u; h = ror32(h, 17) * c1;
    return h;
}

static hv_t city_murmur128(const uint8_t *s, size_t len, uint64_t slo, uint64_t shi) {
    uint64_t a = slo, b = shi, c = 0, d = 0;
    long l = (long)len - 16;
    if (l <= 0) {
        a = city_mix(a * CITY_K1) * CITY_K1;
        c = b * CITY_K1 + city_len0to16(s, len);
        d = city_mix(a + (len >= 8 ? fetch64(s) : c));
    } else {
        c = city_h16(fetch64(s + len - 8) + CITY_K1, a);
        d = city_h16(b + len, c + fetch64(s + len - 16));
        a += d;
        do {
            a ^= city_mix(fetch64(s) * CITY_K1) * CITY_K1;
            a *= CITY_K1;
            b ^= a;
            c ^= city_mix(fetch64(s + 8) * CITY_K1) * CITY_K1;
            c *= CITY_K1;
            d ^= c;
            s += 16;
            l -= 16;
        } while (l > 0);
    }
    a = city_h16(a, c);
    b = city_h16(d, b);
    hv_t out = {{a ^ b, city_h16(b, a), 0, 0}};
    return out;
}

static hv_t city_128_with_seed(const uint8_t *s, size_t len,
                               uint64_t slo, uint64_t shi) {
    if (len < 128)
        return city_murmur128(s, len, slo, shi);
    uint64_t x = slo, y = shi, z = len * CITY_K1;
    uint64_t va, vb, wa, wb;
    va = ror64(y ^ CITY_K1, 49) * CITY_K1 + fetch64(s);
    vb = ror64(va, 42) * CITY_K1 + fetch64(s + 8);
    wa = ror64(y + z, 35) * CITY_K1 + x;
    wb = ror64(x + fetch64(s + 88), 53) * CITY_K1;
    do {
        for (int half = 0; half < 2; half++) {
            x = ror64(x + y + va + fetch64(s + 8), 37) * CITY_K1;
            y = ror64(y + vb + fetch64(s + 48), 42) * CITY_K1;
            x ^= wb;
            y += va + fetch64(s + 40);
            z = ror64(z + wa, 33) * CITY_K1;
            city_weak32(s, vb * CITY_K1, x + wa, &va, &vb);
            city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
            uint64_t t = z; z = x; x = t;
            s += 64;
        }
        len -= 128;
    } while (len >= 128);
    x += ror64(va + z, 49) * CITY_K0;
    z += ror64(wa, 37) * CITY_K0;
    for (size_t tail_done = 0; tail_done < len; ) {
        tail_done += 32;
        y = ror64(x + y, 42) * CITY_K0 + vb;
        wa += fetch64(s + len - tail_done + 16);
        x = x * CITY_K0 + wa;
        z += wb + fetch64(s + len - tail_done);
        wb += va;
        city_weak32(s + len - tail_done, va + z, vb, &va, &vb);
    }
    x = city_h16(x, va);
    y = city_h16(y + z, wa);
    hv_t out = {{city_h16(x + vb, wb) + y, city_h16(x + wb, y + vb), 0, 0}};
    return out;
}

static hv_t city_128(const uint8_t *s, size_t len) {
    if (len >= 16)
        return city_128_with_seed(s + 16, len - 16,
                                  fetch64(s) ^ CITY_K3, fetch64(s + 8));
    if (len >= 8)
        return city_128_with_seed(NULL, 0, fetch64(s) ^ (len * CITY_K0),
                                  fetch64(s + len - 8) ^ CITY_K1);
    return city_128_with_seed(s, len, CITY_K0, CITY_K1);
}

/* CRC-based 256/128-bit City (City.cpp:488-600, SSE4.2 path) */
static void city_crc256_long(const uint8_t *s, size_t len, uint32_t seed,
                             uint64_t *result) {
    uint64_t a = fetch64(s + 56) + CITY_K0;
    uint64_t b = fetch64(s + 96) + CITY_K0;
    uint64_t c = result[0] = city_h16(b, len);
    uint64_t d = result[1] = fetch64(s + 120) * CITY_K0 + len;
    uint64_t e = fetch64(s + 184) + seed;
    uint64_t f = seed;
    uint64_t g = 0, h = 0, i = 0, j = 0;
    uint64_t t = c + d;
    size_t iters = len / 240;
    len -= iters * 240;
#define CITY_CHUNK(mult, zbits) do {                                   \
        uint64_t old_a = a;                                             \
        a = ror64(b, 41 ^ (zbits)) * (mult) + fetch64(s);               \
        b = ror64(c, 27 ^ (zbits)) * (mult) + fetch64(s + 8);           \
        c = ror64(d, 41 ^ (zbits)) * (mult) + fetch64(s + 16);          \
        d = ror64(e, 33 ^ (zbits)) * (mult) + fetch64(s + 24);          \
        e = ror64(t, 25 ^ (zbits)) * (mult) + fetch64(s + 32);          \
        t = old_a;                                                      \
        f = crc32c_u64(f, a);                                           \
        g = crc32c_u64(g, b);                                           \
        h = crc32c_u64(h, c);                                           \
        i = crc32c_u64(i, d);                                           \
        j = crc32c_u64(j, e);                                           \
        s += 40;                                                        \
    } while (0)
    do {
        CITY_CHUNK(1, 1); CITY_CHUNK(CITY_K0, 0);
        CITY_CHUNK(1, 1); CITY_CHUNK(CITY_K0, 0);
        CITY_CHUNK(1, 1); CITY_CHUNK(CITY_K0, 0);
    } while (--iters > 0);
    while (len >= 40) {
        CITY_CHUNK(CITY_K0, 0);
        len -= 40;
    }
    if (len > 0) {
        s = s + len - 40;
        CITY_CHUNK(CITY_K0, 0);
    }
#undef CITY_CHUNK
    j += i << 32;
    a = city_h16(a, j);
    h += g << 32;
    b += h;
    c = city_h16(c, f) + i;
    d = city_h16(d, e + result[0]);
    j += e;
    i += city_h16(h, t);
    e = city_h16(a, d) + j;
    f = city_h16(b, c) + a;
    g = city_h16(j, i) + c;
    result[0] = e + f + g + h;
    a = city_mix((a + g) * CITY_K0) * CITY_K0 + b;
    result[1] += a + result[0];
    a = city_mix(a * CITY_K0) * CITY_K0 + c;
    result[2] = a + result[1];
    a = city_mix((a + e) * CITY_K0) * CITY_K0;
    result[3] = a + result[2];
}

static void city_crc256(const uint8_t *s, size_t len, uint64_t *result) {
    if (len >= 240) {
        city_crc256_long(s, len, 0, result);
    } else {
        uint8_t buf[240];
        memcpy(buf, s, len);
        memset(buf + len, 0, 240 - len);
        city_crc256_long(buf, 240, ~(uint32_t)len, result);
    }
}

static hv_t city_crc128_with_seed(const uint8_t *s, size_t len,
                                  uint64_t slo, uint64_t shi) {
    if (len <= 900)
        return city_128_with_seed(s, len, slo, shi);
    uint64_t result[4];
    city_crc256(s, len, result);
    uint64_t u = shi + result[0];
    uint64_t v = slo + result[1];
    hv_t out = {{city_h16(u, v + result[2]),
                 city_h16(ror64(v, 32), u * CITY_K0 + result[3]), 0, 0}};
    return out;
}

static hv_t city_crc128(const uint8_t *s, size_t len) {
    if (len <= 900)
        return city_128(s, len);
    uint64_t result[4];
    city_crc256(s, len, result);
    hv_t out = {{result[2], result[3], 0, 0}};
    return out;
}

/* ------------------------------------------------------------------ */
/* FarmHash (Pike) — the portable (non-SIMD) dispatch of the farmhash-c
 * build: farmhash32 -> mk, farmhash64 -> xo (na for <=256), seeded 64 ->
 * na_with_seed, 128-bit + fingerprints -> cc (CityHash-v1.1 flavored).
 * The reference's zero-seed farm_32/farm_64 are SIMD variants on AVX
 * builds and explicitly "not portable, may differ between platforms"
 * (farmhash-c.c:1553-1566); we pin the portable variants.              */
/* ------------------------------------------------------------------ */

static inline uint64_t farm_h16_mul(uint64_t u, uint64_t v, uint64_t mul) {
    uint64_t a = (u ^ v) * mul;
    a ^= a >> 47;
    uint64_t b = (v ^ a) * mul;
    b ^= b >> 47;
    return b * mul;
}
static inline uint64_t farm_h16(uint64_t u, uint64_t v) {
    return city_h16(u, v);   /* same murmur-style 128->64 fold */
}

static uint64_t farm_na_len0to16(const uint8_t *s, size_t len) {
    if (len >= 8) {
        uint64_t mul = CITY_K2 + len * 2;
        uint64_t a = fetch64(s) + CITY_K2;
        uint64_t b = fetch64(s + len - 8);
        uint64_t c = ror64(b, 37) * mul + a;
        uint64_t d = (ror64(a, 25) + b) * mul;
        return farm_h16_mul(c, d, mul);
    }
    if (len >= 4) {
        uint64_t mul = CITY_K2 + len * 2;
        uint64_t a = fetch32(s);
        return farm_h16_mul(len + (a << 3), fetch32(s + len - 4), mul);
    }
    if (len > 0) {
        uint8_t a = s[0], b = s[len >> 1], c = s[len - 1];
        uint32_t y = (uint32_t)a + ((uint32_t)b << 8);
        uint32_t z = (uint32_t)len + ((uint32_t)c << 2);
        return city_mix(y * CITY_K2 ^ z * CITY_K0) * CITY_K2;
    }
    return CITY_K2;
}

static uint64_t farm_na_len17to32(const uint8_t *s, size_t len) {
    uint64_t mul = CITY_K2 + len * 2;
    uint64_t a = fetch64(s) * CITY_K1;
    uint64_t b = fetch64(s + 8);
    uint64_t c = fetch64(s + len - 8) * mul;
    uint64_t d = fetch64(s + len - 16) * CITY_K2;
    return farm_h16_mul(ror64(a + b, 43) + ror64(c, 30) + d,
                        a + ror64(b + CITY_K2, 18) + c, mul);
}

static uint64_t farm_na_len33to64(const uint8_t *s, size_t len) {
    uint64_t mul = CITY_K2 + len * 2;
    uint64_t a = fetch64(s) * CITY_K2;
    uint64_t b = fetch64(s + 8);
    uint64_t c = fetch64(s + len - 8) * mul;
    uint64_t d = fetch64(s + len - 16) * CITY_K2;
    uint64_t y = ror64(a + b, 43) + ror64(c, 30) + d;
    uint64_t z = farm_h16_mul(y, a + ror64(b + CITY_K2, 18) + c, mul);
    uint64_t e = fetch64(s + 16) * mul;
    uint64_t f = fetch64(s + 24);
    uint64_t g = (y + fetch64(s + len - 32)) * mul;
    uint64_t h = (z + fetch64(s + len - 24)) * mul;
    return farm_h16_mul(ror64(e + f, 43) + ror64(g, 30) + h,
                        e + ror64(f + a, 18) + g, mul);
}

static uint64_t farm_64_na(const uint8_t *s, size_t len) {
    const uint64_t seed = 81;
    if (len <= 32)
        return len <= 16 ? farm_na_len0to16(s, len) : farm_na_len17to32(s, len);
    if (len <= 64)
        return farm_na_len33to64(s, len);
    uint64_t x = seed;
    uint64_t y = seed * CITY_K1 + 113;
    uint64_t z = city_mix(y * CITY_K2 + 113) * CITY_K2;
    uint64_t va = 0, vb = 0, wa = 0, wb = 0;
    x = x * CITY_K2 + fetch64(s);
    const uint8_t *end = s + ((len - 1) / 64) * 64;
    const uint8_t *last64 = end + ((len - 1) & 63) - 63;
    do {
        x = ror64(x + y + va + fetch64(s + 8), 37) * CITY_K1;
        y = ror64(y + vb + fetch64(s + 48), 42) * CITY_K1;
        x ^= wb;
        y += va + fetch64(s + 40);
        z = ror64(z + wa, 33) * CITY_K1;
        city_weak32(s, vb * CITY_K1, x + wa, &va, &vb);
        city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
        uint64_t t = z; z = x; x = t;
        s += 64;
    } while (s != end);
    uint64_t mul = CITY_K1 + ((z & 0xff) << 1);
    s = last64;
    wa += (len - 1) & 63;
    va += wa;
    wa += va;
    x = ror64(x + y + va + fetch64(s + 8), 37) * mul;
    y = ror64(y + vb + fetch64(s + 48), 42) * mul;
    x ^= wb * 9;
    y += va * 9 + fetch64(s + 40);
    z = ror64(z + wa, 33) * mul;
    city_weak32(s, vb * mul, x + wa, &va, &vb);
    city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
    { uint64_t t = z; z = x; x = t; }
    return farm_h16_mul(farm_h16_mul(va, wa, mul) + city_mix(y) * CITY_K0 + z,
                        farm_h16_mul(vb, wb, mul) + x, mul);
}

static uint64_t farm_64_na_with_seeds(const uint8_t *s, size_t len,
                                      uint64_t seed0, uint64_t seed1) {
    return farm_h16(farm_64_na(s, len) - seed0, seed1);
}

/* farmhash uo (seeded long-input variant; xo defers to it above 256) */
static inline uint64_t farm_uo_h(uint64_t x, uint64_t y, uint64_t mul, int r) {
    uint64_t a = (x ^ y) * mul;
    a ^= a >> 47;
    uint64_t b = (y ^ a) * mul;
    return ror64(b, r) * mul;
}

static uint64_t farm_64_uo_with_seeds(const uint8_t *s, size_t len,
                                      uint64_t seed0, uint64_t seed1) {
    if (len <= 64)
        return farm_64_na_with_seeds(s, len, seed0, seed1);
    uint64_t x = seed0;
    uint64_t y = seed1 * CITY_K2 + 113;
    uint64_t z = city_mix(y * CITY_K2) * CITY_K2;
    uint64_t va = seed0, vb = seed1, wa = 0, wb = 0;
    uint64_t u = x - z;
    x *= CITY_K2;
    uint64_t mul = CITY_K2 + (u & 0x82);
    const uint8_t *end = s + ((len - 1) / 64) * 64;
    const uint8_t *last64 = end + ((len - 1) & 63) - 63;
    do {
        uint64_t a0 = fetch64(s),      a1 = fetch64(s + 8);
        uint64_t a2 = fetch64(s + 16), a3 = fetch64(s + 24);
        uint64_t a4 = fetch64(s + 32), a5 = fetch64(s + 40);
        uint64_t a6 = fetch64(s + 48), a7 = fetch64(s + 56);
        x += a0 + a1;
        y += a2;
        z += a3;
        va += a4;
        vb += a5 + a1;
        wa += a6;
        wb += a7;
        x = ror64(x, 26); x *= 9;
        y = ror64(y, 29);
        z *= mul;
        va = ror64(va, 33);
        vb = ror64(vb, 30);
        wa ^= x; wa *= 9;
        z = ror64(z, 32); z += wb;
        wb += z; z *= 9;
        { uint64_t t = u; u = y; y = t; }
        z += a0 + a6;
        va += a2;
        vb += a3;
        wa += a4;
        wb += a5 + a6;
        x += a1;
        y += a7;
        y += va;
        va += x - y;
        vb += wa;
        wa += vb;
        wb += x - y;
        x += wb;
        wb = ror64(wb, 34);
        { uint64_t t = u; u = z; z = t; }
        s += 64;
    } while (s != end);
    s = last64;
    u *= 9;
    vb = ror64(vb, 28);
    va = ror64(va, 20);
    wa += (len - 1) & 63;
    u += y;
    y += u;
    x = ror64(y - x + va + fetch64(s + 8), 37) * mul;
    y = ror64(y ^ vb ^ fetch64(s + 48), 42) * mul;
    x ^= wb * 9;
    y += va + fetch64(s + 40);
    z = ror64(z + wa, 33) * mul;
    city_weak32(s, vb * mul, x + wa, &va, &vb);
    city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
    return farm_uo_h(farm_h16_mul(va + x, wa ^ y, mul) + z - u,
                     farm_uo_h(vb + y, wb + z, CITY_K2, 30) ^ x,
                     CITY_K2, 31);
}

/* farmhash xo — the portable-build farmhash64 */
static uint64_t farm_xo_h32(const uint8_t *s, size_t len, uint64_t mul,
                            uint64_t seed0, uint64_t seed1) {
    uint64_t a = fetch64(s) * CITY_K1;
    uint64_t b = fetch64(s + 8);
    uint64_t c = fetch64(s + len - 8) * mul;
    uint64_t d = fetch64(s + len - 16) * CITY_K2;
    uint64_t u = ror64(a + b, 43) + ror64(c, 30) + d + seed0;
    uint64_t v = a + ror64(b + CITY_K2, 18) + c + seed1;
    a = city_mix((u ^ v) * mul);
    b = city_mix((v ^ a) * mul);
    return b;
}

static uint64_t farm_64_xo(const uint8_t *s, size_t len) {
    if (len <= 32)
        return len <= 16 ? farm_na_len0to16(s, len) : farm_na_len17to32(s, len);
    if (len <= 64) {
        uint64_t mul0 = CITY_K2 - 30, mul1 = CITY_K2 - 30 + 2 * len;
        uint64_t h0 = farm_xo_h32(s, 32, mul0, 0, 0);
        uint64_t h1 = farm_xo_h32(s + len - 32, 32, mul1, 0, 0);
        return ((h1 * mul1) + h0) * mul1;
    }
    if (len <= 96) {
        uint64_t mul0 = CITY_K2 - 114, mul1 = CITY_K2 - 114 + 2 * len;
        uint64_t h0 = farm_xo_h32(s, 32, mul0, 0, 0);
        uint64_t h1 = farm_xo_h32(s + 32, 32, mul1, 0, 0);
        uint64_t h2 = farm_xo_h32(s + len - 32, 32, mul1, h0, h1);
        return (h2 * 9 + (h0 >> 17) + (h1 >> 21)) * mul1;
    }
    if (len <= 256)
        return farm_64_na(s, len);
    return farm_64_uo_with_seeds(s, len, 81, 0);
}

/* farmhash mk — the portable farmhash32 / fingerprint32 */
static uint32_t farm_mk_len13to24(const uint8_t *s, size_t len, uint32_t seed) {
    uint32_t a = fetch32(s - 4 + (len >> 1));
    uint32_t b = fetch32(s + 4);
    uint32_t c = fetch32(s + len - 8);
    uint32_t d = fetch32(s + (len >> 1));
    uint32_t e = fetch32(s);
    uint32_t f = fetch32(s + len - 4);
    uint32_t h = d * 0xcc9e2d51u + (uint32_t)len + seed;
    a = ror32(a, 12) + f;
    h = city_mur(c, h) + a;
    a = ror32(a, 3) + c;
    h = city_mur(e, h) + a;
    a = ror32(a + f, 12) + d;
    h = city_mur(b ^ seed, h) + a;
    return mm3_fmix32(h);
}

static uint32_t farm_mk_len0to4(const uint8_t *s, size_t len, uint32_t seed) {
    uint32_t b = seed, c = 9;
    for (size_t i = 0; i < len; i++) {
        b = b * 0xcc9e2d51u + (uint32_t)(int8_t)s[i];
        c ^= b;
    }
    return mm3_fmix32(city_mur(b, city_mur((uint32_t)len, c)));
}

static uint32_t farm_mk_len5to12(const uint8_t *s, size_t len, uint32_t seed) {
    uint32_t a = (uint32_t)len, b = (uint32_t)len * 5, c = 9, d = b + seed;
    a += fetch32(s);
    b += fetch32(s + len - 4);
    c += fetch32(s + ((len >> 1) & 4));
    return mm3_fmix32(seed ^ city_mur(c, city_mur(b, city_mur(a, d))));
}

static uint32_t farm_32_mk(const uint8_t *s, size_t len) {
    const uint32_t c1 = 0xcc9e2d51u;
    if (len <= 24)
        return len <= 12
            ? (len <= 4 ? farm_mk_len0to4(s, len, 0) : farm_mk_len5to12(s, len, 0))
            : farm_mk_len13to24(s, len, 0);
    uint32_t h = (uint32_t)len, g = c1 * (uint32_t)len, f = g;
    uint32_t a0 = ror32(fetch32(s + len - 4) * c1, 17) * 0x1b873593u;
    uint32_t a1 = ror32(fetch32(s + len - 8) * c1, 17) * 0x1b873593u;
    uint32_t a2 = ror32(fetch32(s + len - 16) * c1, 17) * 0x1b873593u;
    uint32_t a3 = ror32(fetch32(s + len - 12) * c1, 17) * 0x1b873593u;
    uint32_t a4 = ror32(fetch32(s + len - 20) * c1, 17) * 0x1b873593u;
    h ^= a0; h = ror32(h, 19); h = h * 5 + 0xe6546b64u;
    h ^= a2; h = ror32(h, 19); h = h * 5 + 0xe6546b64u;
    g ^= a1; g = ror32(g, 19); g = g * 5 + 0xe6546b64u;
    g ^= a3; g = ror32(g, 19); g = g * 5 + 0xe6546b64u;
    f += a4; f = ror32(f, 19) + 113;
    size_t iters = (len - 1) / 20;
    do {
        uint32_t a = fetch32(s);
        uint32_t b = fetch32(s + 4);
        uint32_t c = fetch32(s + 8);
        uint32_t d = fetch32(s + 12);
        uint32_t e = fetch32(s + 16);
        h += a;
        g += b;
        f += c;
        h = city_mur(d, h) + e;
        g = city_mur(c, g) + a;
        f = city_mur(b + e * c1, f) + d;
        f += g;
        g += f;
        s += 20;
    } while (--iters != 0);
    g = ror32(g, 11) * c1;
    g = ror32(g, 17) * c1;
    f = ror32(f, 11) * c1;
    f = ror32(f, 17) * c1;
    h = ror32(h + g, 19); h = h * 5 + 0xe6546b64u; h = ror32(h, 17) * c1;
    h = ror32(h + f, 19); h = h * 5 + 0xe6546b64u; h = ror32(h, 17) * c1;
    return h;
}

static uint32_t farm_32_mk_with_seed(const uint8_t *s, size_t len, uint32_t seed) {
    if (len <= 24) {
        if (len >= 13) return farm_mk_len13to24(s, len, seed * 0xcc9e2d51u);
        if (len >= 5)  return farm_mk_len5to12(s, len, seed);
        return farm_mk_len0to4(s, len, seed);
    }
    uint32_t h = farm_mk_len13to24(s, 24, seed ^ (uint32_t)len);
    return city_mur(farm_32_mk(s + 24, len - 24) + seed, h);
}

/* farmhash cc — CityHash-v1.1-flavored 128-bit (farm_128 + fingerprints) */
static uint64_t farm_cc_len0to16(const uint8_t *s, size_t len) {
    return farm_na_len0to16(s, len);   /* identical body (farmhash-c.c:1392) */
}

static hv_t farm_cc_city_murmur(const uint8_t *s, size_t len,
                                uint64_t slo, uint64_t shi) {
    uint64_t a = slo, b = shi, c = 0, d = 0;
    long l = (long)len - 16;
    if (l <= 0) {
        a = city_mix(a * CITY_K1) * CITY_K1;
        c = b * CITY_K1 + farm_cc_len0to16(s, len);
        d = city_mix(a + (len >= 8 ? fetch64(s) : c));
    } else {
        c = farm_h16(fetch64(s + len - 8) + CITY_K1, a);
        d = farm_h16(b + len, c + fetch64(s + len - 16));
        a += d;
        do {
            a ^= city_mix(fetch64(s) * CITY_K1) * CITY_K1;
            a *= CITY_K1;
            b ^= a;
            c ^= city_mix(fetch64(s + 8) * CITY_K1) * CITY_K1;
            c *= CITY_K1;
            d ^= c;
            s += 16;
            l -= 16;
        } while (l > 0);
    }
    a = farm_h16(a, c);
    b = farm_h16(d, b);
    hv_t out = {{a ^ b, farm_h16(b, a), 0, 0}};
    return out;
}

static hv_t farm_128_cc_with_seed(const uint8_t *s, size_t len,
                                  uint64_t slo, uint64_t shi) {
    if (len < 128)
        return farm_cc_city_murmur(s, len, slo, shi);
    uint64_t x = slo, y = shi, z = len * CITY_K1;
    uint64_t va, vb, wa, wb;
    va = ror64(y ^ CITY_K1, 49) * CITY_K1 + fetch64(s);
    vb = ror64(va, 42) * CITY_K1 + fetch64(s + 8);
    wa = ror64(y + z, 35) * CITY_K1 + x;
    wb = ror64(x + fetch64(s + 88), 53) * CITY_K1;
    do {
        for (int half = 0; half < 2; half++) {
            x = ror64(x + y + va + fetch64(s + 8), 37) * CITY_K1;
            y = ror64(y + vb + fetch64(s + 48), 42) * CITY_K1;
            x ^= wb;
            y += va + fetch64(s + 40);
            z = ror64(z + wa, 33) * CITY_K1;
            city_weak32(s, vb * CITY_K1, x + wa, &va, &vb);
            city_weak32(s + 32, z + wb, y + fetch64(s + 16), &wa, &wb);
            uint64_t t = z; z = x; x = t;
            s += 64;
        }
        len -= 128;
    } while (len >= 128);
    x += ror64(va + z, 49) * CITY_K0;
    y = y * CITY_K0 + ror64(wb, 37);
    z = z * CITY_K0 + ror64(wa, 27);
    wa *= 9;
    va *= CITY_K0;
    for (size_t tail_done = 0; tail_done < len; ) {
        tail_done += 32;
        y = ror64(x + y, 42) * CITY_K0 + vb;
        wa += fetch64(s + len - tail_done + 16);
        x = x * CITY_K0 + wa;
        z += wb + fetch64(s + len - tail_done);
        wb += va;
        city_weak32(s + len - tail_done, va + z, vb, &va, &vb);
        va *= CITY_K0;
    }
    x = farm_h16(x, va);
    y = farm_h16(y + z, wa);
    hv_t out = {{farm_h16(x + vb, wb) + y, farm_h16(x + wb, y + vb), 0, 0}};
    return out;
}

static hv_t farm_128_cc(const uint8_t *s, size_t len) {
    if (len >= 16)
        return farm_128_cc_with_seed(s + 16, len - 16,
                                     fetch64(s), fetch64(s + 8) + CITY_K0);
    return farm_128_cc_with_seed(s, len, CITY_K0, CITY_K1);
}

/* ------------------------------------------------------------------ */
/* SpookyHash (Jenkins) — the V1 revision vendored by pyhash (the Short
 * path OVERWRITES d with length<<56; V2 changed that to +=).           */
/* ------------------------------------------------------------------ */

#define SPOOKY_CONST 0xdeadbeefdeadbeefULL

static void spooky_short_mix(uint64_t *h0, uint64_t *h1, uint64_t *h2, uint64_t *h3) {
    uint64_t a = *h0, b = *h1, c = *h2, d = *h3;
    c = rotl64(c, 50); c += d; a ^= c;
    d = rotl64(d, 52); d += a; b ^= d;
    a = rotl64(a, 30); a += b; c ^= a;
    b = rotl64(b, 41); b += c; d ^= b;
    c = rotl64(c, 54); c += d; a ^= c;
    d = rotl64(d, 48); d += a; b ^= d;
    a = rotl64(a, 38); a += b; c ^= a;
    b = rotl64(b, 37); b += c; d ^= b;
    c = rotl64(c, 62); c += d; a ^= c;
    d = rotl64(d, 34); d += a; b ^= d;
    a = rotl64(a, 5);  a += b; c ^= a;
    b = rotl64(b, 36); b += c; d ^= b;
    *h0 = a; *h1 = b; *h2 = c; *h3 = d;
}

static void spooky_short_end(uint64_t *h0, uint64_t *h1, uint64_t *h2, uint64_t *h3) {
    uint64_t a = *h0, b = *h1, c = *h2, d = *h3;
    d ^= c; c = rotl64(c, 15); d += c;
    a ^= d; d = rotl64(d, 52); a += d;
    b ^= a; a = rotl64(a, 26); b += a;
    c ^= b; b = rotl64(b, 51); c += b;
    d ^= c; c = rotl64(c, 28); d += c;
    a ^= d; d = rotl64(d, 9);  a += d;
    b ^= a; a = rotl64(a, 47); b += a;
    c ^= b; b = rotl64(b, 54); c += b;
    d ^= c; c = rotl64(c, 32); d += c;
    a ^= d; d = rotl64(d, 25); a += d;
    b ^= a; a = rotl64(a, 63); b += a;
    *h0 = a; *h1 = b; *h2 = c; *h3 = d;
}

static void spooky_short(const uint8_t *msg, size_t length,
                         uint64_t *hash1, uint64_t *hash2) {
    size_t remainder = length % 32;
    uint64_t a = *hash1, b = *hash2, c = SPOOKY_CONST, d = SPOOKY_CONST;
    const uint8_t *p = msg;
    if (length > 15) {
        const uint8_t *end = msg + (length / 32) * 32;
        for (; p < end; p += 32) {
            c += fetch64(p);
            d += fetch64(p + 8);
            spooky_short_mix(&a, &b, &c, &d);
            a += fetch64(p + 16);
            b += fetch64(p + 24);
        }
        if (remainder >= 16) {
            c += fetch64(p);
            d += fetch64(p + 8);
            spooky_short_mix(&a, &b, &c, &d);
            p += 16;
            remainder -= 16;
        }
    }
    d = ((uint64_t)length) << 56;            /* V1: overwrite, not += */
    switch (remainder) {
        case 15: d += ((uint64_t)p[14]) << 48; /* fallthrough */
        case 14: d += ((uint64_t)p[13]) << 40; /* fallthrough */
        case 13: d += ((uint64_t)p[12]) << 32; /* fallthrough */
        case 12: d += fetch32(p + 8); c += fetch64(p); break;
        case 11: d += ((uint64_t)p[10]) << 16; /* fallthrough */
        case 10: d += ((uint64_t)p[9]) << 8;   /* fallthrough */
        case 9:  d += (uint64_t)p[8];          /* fallthrough */
        case 8:  c += fetch64(p); break;
        case 7:  c += ((uint64_t)p[6]) << 48;  /* fallthrough */
        case 6:  c += ((uint64_t)p[5]) << 40;  /* fallthrough */
        case 5:  c += ((uint64_t)p[4]) << 32;  /* fallthrough */
        case 4:  c += fetch32(p); break;
        case 3:  c += ((uint64_t)p[2]) << 16;  /* fallthrough */
        case 2:  c += ((uint64_t)p[1]) << 8;   /* fallthrough */
        case 1:  c += (uint64_t)p[0]; break;
        case 0:  c += SPOOKY_CONST; d += SPOOKY_CONST;
    }
    spooky_short_end(&a, &b, &c, &d);
    *hash1 = a;
    *hash2 = b;
}

static void spooky_mix(const uint8_t *p, uint64_t *s) {
    s[0] += fetch64(p);      s[2] ^= s[10]; s[11] ^= s[0];  s[0] = rotl64(s[0], 11);  s[11] += s[1];
    s[1] += fetch64(p + 8);  s[3] ^= s[11]; s[0] ^= s[1];   s[1] = rotl64(s[1], 32);  s[0] += s[2];
    s[2] += fetch64(p + 16); s[4] ^= s[0];  s[1] ^= s[2];   s[2] = rotl64(s[2], 43);  s[1] += s[3];
    s[3] += fetch64(p + 24); s[5] ^= s[1];  s[2] ^= s[3];   s[3] = rotl64(s[3], 31);  s[2] += s[4];
    s[4] += fetch64(p + 32); s[6] ^= s[2];  s[3] ^= s[4];   s[4] = rotl64(s[4], 17);  s[3] += s[5];
    s[5] += fetch64(p + 40); s[7] ^= s[3];  s[4] ^= s[5];   s[5] = rotl64(s[5], 28);  s[4] += s[6];
    s[6] += fetch64(p + 48); s[8] ^= s[4];  s[5] ^= s[6];   s[6] = rotl64(s[6], 39);  s[5] += s[7];
    s[7] += fetch64(p + 56); s[9] ^= s[5];  s[6] ^= s[7];   s[7] = rotl64(s[7], 57);  s[6] += s[8];
    s[8] += fetch64(p + 64); s[10] ^= s[6]; s[7] ^= s[8];   s[8] = rotl64(s[8], 55);  s[7] += s[9];
    s[9] += fetch64(p + 72); s[11] ^= s[7]; s[8] ^= s[9];   s[9] = rotl64(s[9], 54);  s[8] += s[10];
    s[10] += fetch64(p + 80); s[0] ^= s[8]; s[9] ^= s[10];  s[10] = rotl64(s[10], 22); s[9] += s[11];
    s[11] += fetch64(p + 88); s[1] ^= s[9]; s[10] ^= s[11]; s[11] = rotl64(s[11], 46); s[10] += s[0];
}

static void spooky_end_partial(uint64_t *h) {
    h[11] += h[1]; h[2] ^= h[11]; h[1] = rotl64(h[1], 44);
    h[0] += h[2];  h[3] ^= h[0];  h[2] = rotl64(h[2], 15);
    h[1] += h[3];  h[4] ^= h[1];  h[3] = rotl64(h[3], 34);
    h[2] += h[4];  h[5] ^= h[2];  h[4] = rotl64(h[4], 21);
    h[3] += h[5];  h[6] ^= h[3];  h[5] = rotl64(h[5], 38);
    h[4] += h[6];  h[7] ^= h[4];  h[6] = rotl64(h[6], 33);
    h[5] += h[7];  h[8] ^= h[5];  h[7] = rotl64(h[7], 10);
    h[6] += h[8];  h[9] ^= h[6];  h[8] = rotl64(h[8], 13);
    h[7] += h[9];  h[10] ^= h[7]; h[9] = rotl64(h[9], 38);
    h[8] += h[10]; h[11] ^= h[8]; h[10] = rotl64(h[10], 53);
    h[9] += h[11]; h[0] ^= h[9];  h[11] = rotl64(h[11], 42);
    h[10] += h[0]; h[1] ^= h[10]; h[0] = rotl64(h[0], 54);
}

static void spooky_hash128(const uint8_t *msg, size_t length,
                           uint64_t *hash1, uint64_t *hash2) {
    if (length < 192) {                       /* sc_bufSize = 2*96 */
        spooky_short(msg, length, hash1, hash2);
        return;
    }
    uint64_t h[12];
    h[0] = h[3] = h[6] = h[9] = *hash1;
    h[1] = h[4] = h[7] = h[10] = *hash2;
    h[2] = h[5] = h[8] = h[11] = SPOOKY_CONST;
    const uint8_t *p = msg;
    const uint8_t *end = msg + (length / 96) * 96;
    while (p < end) {
        spooky_mix(p, h);
        p += 96;
    }
    size_t remainder = length - (size_t)(end - msg);
    uint8_t buf[96];
    memcpy(buf, end, remainder);
    memset(buf + remainder, 0, 96 - remainder);
    buf[95] = (uint8_t)remainder;
    spooky_mix(buf, h);
    spooky_end_partial(h);
    spooky_end_partial(h);
    spooky_end_partial(h);
    *hash1 = h[0];
    *hash2 = h[1];
}

/* ------------------------------------------------------------------ */
/* MetroHash (Rogers) — 64/128 variants 1 & 2 plus the CRC variants
 * (software CRC-32C replaces the SSE4.2 instruction bit-exactly).      */
/* ------------------------------------------------------------------ */

static uint64_t metro_64(const uint8_t *p, size_t len, uint32_t seed, int v2) {
    const uint64_t k0 = v2 ? 0xD6D018F5 : 0xC83A91E1;
    const uint64_t k1 = v2 ? 0xA2AA033B : 0x8648DBDB;
    const uint64_t k2 = v2 ? 0x62992FC1 : 0x7BDEC03B;
    const uint64_t k3 = v2 ? 0x30BC5B29 : 0x2F5870A5;
    const uint8_t *end = p + len;
    uint64_t hash = ((uint64_t)seed + k2) * k0 + len;
    if (len >= 32) {
        uint64_t v[4] = {hash, hash, hash, hash};
        do {
            v[0] += fetch64(p) * k0; p += 8; v[0] = ror64(v[0], 29) + v[2];
            v[1] += fetch64(p) * k1; p += 8; v[1] = ror64(v[1], 29) + v[3];
            v[2] += fetch64(p) * k2; p += 8; v[2] = ror64(v[2], 29) + v[0];
            v[3] += fetch64(p) * k3; p += 8; v[3] = ror64(v[3], 29) + v[1];
        } while (p <= end - 32);
        int r = v2 ? 30 : 33;
        v[2] ^= ror64(((v[0] + v[3]) * k0) + v[1], r) * k1;
        v[3] ^= ror64(((v[1] + v[2]) * k1) + v[0], r) * k0;
        v[0] ^= ror64(((v[0] + v[2]) * k0) + v[3], r) * k1;
        v[1] ^= ror64(((v[1] + v[3]) * k1) + v[2], r) * k0;
        hash += v[0] ^ v[1];
    }
    if (end - p >= 16) {
        uint64_t v0, v1;
        if (v2) {
            v0 = hash + fetch64(p) * k2; p += 8; v0 = ror64(v0, 29) * k3;
            v1 = hash + fetch64(p) * k2; p += 8; v1 = ror64(v1, 29) * k3;
            v0 ^= ror64(v0 * k0, 34) + v1;
            v1 ^= ror64(v1 * k3, 34) + v0;
        } else {
            v0 = hash + fetch64(p) * k0; p += 8; v0 = ror64(v0, 33) * k1;
            v1 = hash + fetch64(p) * k1; p += 8; v1 = ror64(v1, 33) * k2;
            v0 ^= ror64(v0 * k0, 35) + v1;
            v1 ^= ror64(v1 * k3, 35) + v0;
        }
        hash += v1;
    }
    if (end - p >= 8) {
        hash += fetch64(p) * k3; p += 8;
        hash ^= ror64(hash, v2 ? 36 : 33) * k1;
    }
    if (end - p >= 4) {
        hash += fetch32(p) * k3; p += 4;
        hash ^= ror64(hash, 15) * k1;
    }
    if (end - p >= 2) {
        hash += fetch16(p) * k3; p += 2;
        hash ^= ror64(hash, v2 ? 15 : 13) * k1;
    }
    if (end - p >= 1) {
        hash += (*p) * k3;
        hash ^= ror64(hash, v2 ? 23 : 25) * k1;
    }
    hash ^= ror64(hash, v2 ? 28 : 33);
    hash *= k0;
    hash ^= ror64(hash, v2 ? 29 : 33);
    return hash;
}

static hv_t metro_128(const uint8_t *p, size_t len, uint32_t seed, int v2) {
    const uint64_t k0 = v2 ? 0xD6D018F5 : 0xC83A91E1;
    const uint64_t k1 = v2 ? 0xA2AA033B : 0x8648DBDB;
    const uint64_t k2 = v2 ? 0x62992FC1 : 0x7BDEC03B;
    const uint64_t k3 = v2 ? 0x30BC5B29 : 0x2F5870A5;
    const uint8_t *end = p + len;
    uint64_t v[4];
    v[0] = ((uint64_t)seed - k0) * k3 + len;
    v[1] = ((uint64_t)seed + k1) * k2 + len;
    if (len >= 32) {
        v[2] = ((uint64_t)seed + k0) * k2 + len;
        v[3] = ((uint64_t)seed - k1) * k3 + len;
        do {
            v[0] += fetch64(p) * k0; p += 8; v[0] = ror64(v[0], 29) + v[2];
            v[1] += fetch64(p) * k1; p += 8; v[1] = ror64(v[1], 29) + v[3];
            v[2] += fetch64(p) * k2; p += 8; v[2] = ror64(v[2], 29) + v[0];
            v[3] += fetch64(p) * k3; p += 8; v[3] = ror64(v[3], 29) + v[1];
        } while (p <= end - 32);
        if (v2) {
            v[2] ^= ror64(((v[0] + v[3]) * k0) + v[1], 33) * k1;
            v[3] ^= ror64(((v[1] + v[2]) * k1) + v[0], 33) * k0;
            v[0] ^= ror64(((v[0] + v[2]) * k0) + v[3], 33) * k1;
            v[1] ^= ror64(((v[1] + v[3]) * k1) + v[2], 33) * k0;
        } else {
            v[2] ^= ror64(((v[0] + v[3]) * k0) + v[1], 26) * k1;
            v[3] ^= ror64(((v[1] + v[2]) * k1) + v[0], 26) * k0;
            v[0] ^= ror64(((v[0] + v[2]) * k0) + v[3], 26) * k1;
            v[1] ^= ror64(((v[1] + v[3]) * k1) + v[2], 30) * k0;
        }
    }
    if (end - p >= 16) {
        int ra = v2 ? 29 : 33, rb = v2 ? 29 : 17;
        v[0] += fetch64(p) * k2; p += 8; v[0] = ror64(v[0], ra) * k3;
        v[1] += fetch64(p) * k2; p += 8; v[1] = ror64(v[1], ra) * k3;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (end - p >= 8) {
        int ra = v2 ? 29 : 33, rb = v2 ? 29 : 20;
        v[0] += fetch64(p) * k2; p += 8; v[0] = ror64(v[0], ra) * k3;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
    }
    if (end - p >= 4) {
        int ra = v2 ? 29 : 33, rb = v2 ? 25 : 18;
        v[1] += fetch32(p) * k2; p += 4; v[1] = ror64(v[1], ra) * k3;
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (end - p >= 2) {
        int ra = v2 ? 29 : 33, rb = v2 ? 30 : 24;
        v[0] += fetch16(p) * k2; p += 2; v[0] = ror64(v[0], ra) * k3;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
    }
    if (end - p >= 1) {
        int ra = v2 ? 29 : 33, rb = v2 ? 18 : 24;
        v[1] += (*p) * k2; v[1] = ror64(v[1], ra) * k3;
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (v2) {
        v[0] += ror64((v[0] * k0) + v[1], 33);
        v[1] += ror64((v[1] * k1) + v[0], 33);
        v[0] += ror64((v[0] * k2) + v[1], 33);
        v[1] += ror64((v[1] * k3) + v[0], 33);
    } else {
        v[0] += ror64((v[0] * k0) + v[1], 13);
        v[1] += ror64((v[1] * k1) + v[0], 37);
        v[0] += ror64((v[0] * k2) + v[1], 13);
        v[1] += ror64((v[1] * k3) + v[0], 37);
    }
    hv_t out = {{v[0], v[1], 0, 0}};
    return out;
}

static uint64_t metro_64_crc(const uint8_t *p, size_t len, uint32_t seed, int v2) {
    const uint64_t k0 = v2 ? 0xD6D018F5 : 0xC83A91E1;
    const uint64_t k1 = v2 ? 0xA2AA033B : 0x8648DBDB;
    const uint64_t k2 = v2 ? 0x62992FC1 : 0x7BDEC03B;
    const uint64_t k3 = v2 ? 0x30BC5B29 : 0x2F5870A5;
    const uint8_t *end = p + len;
    uint64_t hash = ((uint64_t)seed + k2) * k0 + len;
    if (len >= 32) {
        uint64_t v[4] = {hash, hash, hash, hash};
        do {
            v[0] ^= crc32c_u64(v[0], fetch64(p)); p += 8;
            v[1] ^= crc32c_u64(v[1], fetch64(p)); p += 8;
            v[2] ^= crc32c_u64(v[2], fetch64(p)); p += 8;
            v[3] ^= crc32c_u64(v[3], fetch64(p)); p += 8;
        } while (p <= end - 32);
        v[2] ^= ror64(((v[0] + v[3]) * k0) + v[1], 33) * k1;
        v[3] ^= ror64(((v[1] + v[2]) * k1) + v[0], 33) * k0;
        v[0] ^= ror64(((v[0] + v[2]) * k0) + v[3], 33) * k1;
        v[1] ^= ror64(((v[1] + v[3]) * k1) + v[2], 33) * k0;
        hash += v[0] ^ v[1];
    }
    if (end - p >= 16) {
        uint64_t v0 = hash + fetch64(p) * k0; p += 8; v0 = ror64(v0, 33) * k1;
        uint64_t v1 = hash + fetch64(p) * k1; p += 8; v1 = ror64(v1, 33) * k2;
        v0 ^= ror64(v0 * k0, 35) + v1;
        v1 ^= ror64(v1 * k3, 35) + v0;
        hash += v1;
    }
    if (end - p >= 8) {
        hash += fetch64(p) * k3; p += 8;
        hash ^= ror64(hash, 33) * k1;
    }
    if (end - p >= 4) {
        hash ^= crc32c_u64(hash, fetch32(p)); p += 4;
        hash ^= ror64(hash, 15) * k1;
    }
    if (end - p >= 2) {
        hash ^= crc32c_u64(hash, fetch16(p)); p += 2;
        hash ^= ror64(hash, 13) * k1;
    }
    if (end - p >= 1) {
        hash ^= crc32c_u64(hash, *p);
        hash ^= ror64(hash, 25) * k1;
    }
    hash ^= ror64(hash, 33);
    hash *= k0;
    hash ^= ror64(hash, 33);
    return hash;
}

static hv_t metro_128_crc(const uint8_t *p, size_t len, uint32_t seed, int v2) {
    const uint64_t k0 = v2 ? 0xEE783E2F : 0xC83A91E1;
    const uint64_t k1 = v2 ? 0xAD07C493 : 0x8648DBDB;
    const uint64_t k2 = v2 ? 0x797A90BB : 0x7BDEC03B;
    const uint64_t k3 = v2 ? 0x2E4B2E1B : 0x2F5870A5;
    const uint8_t *end = p + len;
    uint64_t v[4];
    v[0] = ((uint64_t)seed - k0) * k3 + len;
    v[1] = ((uint64_t)seed + k1) * k2 + len;
    if (len >= 32) {
        v[2] = ((uint64_t)seed + k0) * k2 + len;
        v[3] = ((uint64_t)seed - k1) * k3 + len;
        do {
            v[0] ^= crc32c_u64(v[0], fetch64(p)); p += 8;
            v[1] ^= crc32c_u64(v[1], fetch64(p)); p += 8;
            v[2] ^= crc32c_u64(v[2], fetch64(p)); p += 8;
            v[3] ^= crc32c_u64(v[3], fetch64(p)); p += 8;
        } while (p <= end - 32);
        int ra = v2 ? 12 : 34, rb = v2 ? 19 : 37;
        v[2] ^= ror64(((v[0] + v[3]) * k0) + v[1], ra) * k1;
        v[3] ^= ror64(((v[1] + v[2]) * k1) + v[0], rb) * k0;
        v[0] ^= ror64(((v[0] + v[2]) * k0) + v[3], ra) * k1;
        v[1] ^= ror64(((v[1] + v[3]) * k1) + v[2], rb) * k0;
    }
    if (end - p >= 16) {
        int ra = v2 ? 41 : 34, rb = v2 ? 10 : 30;
        v[0] += fetch64(p) * k2; p += 8; v[0] = ror64(v[0], ra) * k3;
        v[1] += fetch64(p) * k2; p += 8; v[1] = ror64(v[1], ra) * k3;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (end - p >= 8) {
        int ra = v2 ? 34 : 36, rb = v2 ? 22 : 23;
        v[0] += fetch64(p) * k2; p += 8; v[0] = ror64(v[0], ra) * k3;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
    }
    if (end - p >= 4) {
        int rb = v2 ? 14 : 19;
        v[1] ^= crc32c_u64(v[0], fetch32(p)); p += 4;
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (end - p >= 2) {
        int rb = v2 ? 15 : 13;
        v[0] ^= crc32c_u64(v[1], fetch16(p)); p += 2;
        v[0] ^= ror64((v[0] * k2) + v[1], rb) * k1;
    }
    if (end - p >= 1) {
        int rb = v2 ? 18 : 17;
        v[1] ^= crc32c_u64(v[0], *p);
        v[1] ^= ror64((v[1] * k3) + v[0], rb) * k0;
    }
    if (v2) {
        v[0] += ror64((v[0] * k0) + v[1], 15);
        v[1] += ror64((v[1] * k1) + v[0], 27);
        v[0] += ror64((v[0] * k0) + v[1], 15);
        v[1] += ror64((v[1] * k1) + v[0], 27);
    } else {
        v[0] += ror64((v[0] * k0) + v[1], 11);
        v[1] += ror64((v[1] * k1) + v[0], 26);
        v[0] += ror64((v[0] * k0) + v[1], 11);
        v[1] += ror64((v[1] * k1) + v[0], 26);
    }
    hv_t out = {{v[0], v[1], 0, 0}};
    return out;
}

/* ------------------------------------------------------------------ */
/* MUM hash (Makarov) — v1, as vendored (smhasher mum.h, unroll 4)     */
/* ------------------------------------------------------------------ */

static inline uint64_t mum_step(uint64_t v, uint64_t p) {
    __uint128_t r = (__uint128_t)v * p;
    uint64_t hi = (uint64_t)(r >> 64), lo = (uint64_t)r;
    return hi + lo;
}

static const uint64_t MUM_PRIMES[16] = {
    0x9ebdcae10d981691ULL, 0x32b9b9b97a27ac7dULL, 0x29b5584d83d35bbdULL,
    0x4b04e0e61401255fULL, 0x25e8f7b1f1c9d027ULL, 0x80d4c8c000f3e881ULL,
    0xbd1255431904b9ddULL, 0x8a3bd4485eee6d81ULL, 0x3bc721b2aad05197ULL,
    0x71b1a19b907d6e33ULL, 0x525e6c1084a8534bULL, 0x9e4c2cd340c1299fULL,
    0xde3add92e94caa37ULL, 0x7e14eadb1f65311dULL, 0x3f5aa40f89812853ULL,
    0x33b15a3b587d15c9ULL,
};

static uint64_t mum_64(const uint8_t *str, size_t len, uint64_t seed) {
    const uint64_t block_start_prime = 0xc42b5e2e6480b23bULL;
    const uint64_t unroll_prime = 0x7b51ec3d22f7096fULL;
    const uint64_t tail_prime = 0xaf47d47c99b1461bULL;
    const uint64_t finish1 = 0xa9a7ae7ceff79f3fULL;
    const uint64_t finish2 = 0xaf47d47c99b1461bULL;
    uint64_t result = seed + len;
    uint64_t u64;
    result = mum_step(result, block_start_prime);
    while (len > 4 * 8) {                   /* unroll factor 4 (x86-64) */
        for (int i = 0; i < 4; i++)
            result ^= mum_step(fetch64(str + 8 * i), MUM_PRIMES[i]);
        len -= 32;
        str += 32;
        result = mum_step(result, unroll_prime);
    }
    size_t n = len / 8;
    for (size_t i = 0; i < n; i++)
        result ^= mum_step(fetch64(str + 8 * i), MUM_PRIMES[i]);
    len -= n * 8;
    str += n * 8;
    switch (len) {
        case 7:
            u64 = fetch32(str);
            u64 |= (uint64_t)str[4] << 32;
            u64 |= (uint64_t)str[5] << 40;
            u64 |= (uint64_t)str[6] << 48;
            result ^= mum_step(u64, tail_prime); break;
        case 6:
            u64 = fetch32(str);
            u64 |= (uint64_t)str[4] << 32;
            u64 |= (uint64_t)str[5] << 40;
            result ^= mum_step(u64, tail_prime); break;
        case 5:
            u64 = fetch32(str);
            u64 |= (uint64_t)str[4] << 32;
            result ^= mum_step(u64, tail_prime); break;
        case 4:
            u64 = fetch32(str);
            result ^= mum_step(u64, tail_prime); break;
        case 3:
            u64 = str[0] | ((uint64_t)str[1] << 8) | ((uint64_t)str[2] << 16);
            result ^= mum_step(u64, tail_prime); break;
        case 2:
            u64 = str[0] | ((uint64_t)str[1] << 8);
            result ^= mum_step(u64, tail_prime); break;
        case 1:
            result ^= mum_step(str[0], tail_prime); break;
    }
    result ^= mum_step(result, finish1);
    result ^= mum_step(result, finish2);
    return result;
}

/* ------------------------------------------------------------------ */
/* t1ha (Yuriev) — t1ha1_le/be, t1ha2_atonce/atonce128; t1ha0 is the
 * reference's runtime-dispatch alias, pinned here to t1ha2_atonce (the
 * non-AES 64-bit little-endian mapping, t1ha.h:652).                   */
/* ------------------------------------------------------------------ */

#define T1HA_P0 0xEC99BF0D8372CAABULL
#define T1HA_P1 0x82434FE90EDCEF39ULL
#define T1HA_P2 0xD4F06DB99D67BE4BULL
#define T1HA_P3 0xBD9CACC22C6E9571ULL
#define T1HA_P4 0x9C06FAF4D023E3ABULL
#define T1HA_P5 0xC060724A8424F345ULL
#define T1HA_P6 0xCB5AF53AE3AAAC31ULL

static inline uint64_t t1ha_mux64(uint64_t v, uint64_t prime) {
    __uint128_t r = (__uint128_t)v * prime;
    return (uint64_t)r ^ (uint64_t)(r >> 64);
}
static inline uint64_t fetch64_be(const uint8_t *p) { return bswap64(fetch64(p)); }
static inline uint64_t t1ha_tail_le(const uint8_t *p, size_t tail) {
    /* last `tail` bytes (tail==8 for 0 mod 8) as a little-endian integer */
    int n = (int)(tail & 7); if (n == 0) n = 8;
    uint64_t r = 0;
    for (int i = n - 1; i >= 0; i--) r = (r << 8) | p[i];
    return r;
}
static inline uint64_t t1ha_tail_be(const uint8_t *p, size_t tail) {
    int n = (int)(tail & 7); if (n == 0) n = 8;
    uint64_t r = 0;
    for (int i = 0; i < n; i++) r = (r << 8) | p[i];
    return r;
}

static uint64_t t1ha1_hash(const uint8_t *data, size_t len, uint64_t seed, int be) {
    uint64_t a = seed, b = len;
    const uint8_t *v = data;
    if (len > 32) {
        uint64_t c = ror64(len, 17) + seed;
        uint64_t d = len ^ ror64(seed, 17);
        const uint8_t *detent = data + len - 31;
        do {
            uint64_t w0 = be ? fetch64_be(v) : fetch64(v);
            uint64_t w1 = be ? fetch64_be(v + 8) : fetch64(v + 8);
            uint64_t w2 = be ? fetch64_be(v + 16) : fetch64(v + 16);
            uint64_t w3 = be ? fetch64_be(v + 24) : fetch64(v + 24);
            v += 32;
            uint64_t d02 = w0 ^ ror64(w2 + d, 17);
            uint64_t c13 = w1 ^ ror64(w3 + c, 17);
            d -= b ^ ror64(w1, 31);
            c += a ^ ror64(w0, 41);
            b ^= T1HA_P0 * (c13 + w2);
            a ^= T1HA_P1 * (d02 + w3);
        } while (v < detent);
        a ^= T1HA_P6 * (ror64(c, 17) + d);
        b ^= T1HA_P5 * (c + ror64(d, 17));
        len &= 31;
    }
    if (len > 24) { b += t1ha_mux64(be ? fetch64_be(v) : fetch64(v), T1HA_P4); v += 8; }
    if (len > 16) { a += t1ha_mux64(be ? fetch64_be(v) : fetch64(v), T1HA_P3); v += 8; }
    if (len > 8)  { b += t1ha_mux64(be ? fetch64_be(v) : fetch64(v), T1HA_P2); v += 8; }
    if (len > 0)  { a += t1ha_mux64(be ? t1ha_tail_be(v, len) : t1ha_tail_le(v, len), T1HA_P1); }
    /* final_weak_avalanche */
    {
        uint64_t s = a + b;
        uint64_t m = t1ha_mux64(ror64(s, 17), T1HA_P4);
        uint64_t x = (a ^ b) * T1HA_P0;
        return m + (x ^ ror64(x, 41));
    }
}

static inline void t1ha2_mixup64(uint64_t *a, uint64_t *b, uint64_t v, uint64_t prime) {
    __uint128_t r = (__uint128_t)(*b + v) * prime;
    *a ^= (uint64_t)r;
    *b += (uint64_t)(r >> 64);
}
static inline uint64_t t1ha2_final64(uint64_t a, uint64_t b) {
    uint64_t x = (a + ror64(b, 41)) * T1HA_P0;
    uint64_t y = (ror64(a, 23) + b) * T1HA_P6;
    return t1ha_mux64(x ^ y, T1HA_P5);
}

typedef struct { uint64_t a, b, c, d; } t1ha2_state;

static void t1ha2_update(t1ha2_state *s, const uint8_t *v) {
    uint64_t w0 = fetch64(v), w1 = fetch64(v + 8);
    uint64_t w2 = fetch64(v + 16), w3 = fetch64(v + 24);
    uint64_t d02 = w0 + ror64(w2 + s->d, 56);
    uint64_t c13 = w1 + ror64(w3 + s->c, 19);
    s->d ^= s->b + ror64(w1, 38);
    s->c ^= s->a + ror64(w0, 57);
    s->b ^= T1HA_P6 * (c13 + w2);
    s->a ^= T1HA_P5 * (d02 + w3);
}

static uint64_t t1ha2_tail_ab(t1ha2_state *s, const uint8_t *v, size_t len) {
    if (len > 24) { t1ha2_mixup64(&s->a, &s->b, fetch64(v), T1HA_P4); v += 8; }
    if (len > 16) { t1ha2_mixup64(&s->b, &s->a, fetch64(v), T1HA_P3); v += 8; }
    if (len > 8)  { t1ha2_mixup64(&s->a, &s->b, fetch64(v), T1HA_P2); v += 8; }
    if (len > 0)  { t1ha2_mixup64(&s->b, &s->a, t1ha_tail_le(v, len), T1HA_P1); }
    return t1ha2_final64(s->a, s->b);
}

static uint64_t t1ha2_atonce(const uint8_t *data, size_t len, uint64_t seed) {
    t1ha2_state s;
    s.a = seed;
    s.b = len;
    if (len > 32) {
        s.c = ror64(len, 23) + ~seed;
        s.d = ~len + ror64(seed, 19);
        const uint8_t *detent = data + len - 31;
        do {
            t1ha2_update(&s, data);
            data += 32;
        } while (data < detent);
        s.a ^= T1HA_P6 * (s.c + ror64(s.d, 23));
        s.b ^= T1HA_P5 * (ror64(s.c, 19) + s.d);
        len &= 31;
    }
    return t1ha2_tail_ab(&s, data, len);
}

static hv_t t1ha2_atonce128(const uint8_t *data, size_t len, uint64_t seed) {
    t1ha2_state s;
    s.a = seed;
    s.b = len;
    s.c = ror64(len, 23) + ~seed;
    s.d = ~len + ror64(seed, 19);
    if (len > 32) {
        const uint8_t *detent = data + len - 31;
        do {
            t1ha2_update(&s, data);
            data += 32;
        } while (data < detent);
        len &= 31;
    }
    const uint8_t *v = data;
    if (len > 24) { t1ha2_mixup64(&s.a, &s.d, fetch64(v), T1HA_P4); v += 8; }
    if (len > 16) { t1ha2_mixup64(&s.b, &s.a, fetch64(v), T1HA_P3); v += 8; }
    if (len > 8)  { t1ha2_mixup64(&s.c, &s.b, fetch64(v), T1HA_P2); v += 8; }
    if (len > 0)  { t1ha2_mixup64(&s.d, &s.c, t1ha_tail_le(v, len), T1HA_P1); }
    /* final128 */
    t1ha2_mixup64(&s.a, &s.b, ror64(s.c, 41) ^ s.d, T1HA_P0);
    t1ha2_mixup64(&s.b, &s.c, ror64(s.d, 23) ^ s.a, T1HA_P6);
    t1ha2_mixup64(&s.c, &s.d, ror64(s.a, 19) ^ s.b, T1HA_P5);
    t1ha2_mixup64(&s.d, &s.a, ror64(s.b, 31) ^ s.c, T1HA_P4);
    hv_t out = {{s.a ^ s.b, s.c + s.d, 0, 0}};
    return out;
}

/* ------------------------------------------------------------------ */
/* Dispatch                                                            */
/* ------------------------------------------------------------------ */

enum algo {
    ALG_FNV1_32, ALG_FNV1A_32, ALG_FNV1_64, ALG_FNV1A_64,
    ALG_MURMUR2_32, ALG_MURMUR2_X64_64A, ALG_MURMUR3_32,
    ALG_XX_32, ALG_XX_64, ALG_SUPER_FAST, ALG_LOOKUP3_LITTLE,
    ALG_MURMUR1_32, ALG_MURMUR2A_32, ALG_MURMUR2_X86_64B,
    ALG_MURMUR3_X86_128, ALG_MURMUR3_X64_128, ALG_LOOKUP3_BIG,
    ALG_CITY_32, ALG_CITY_64, ALG_CITY_128, ALG_CITY_CRC_128,
    ALG_CITY_FP_256,
    ALG_SPOOKY_32, ALG_SPOOKY_64, ALG_SPOOKY_128,
    ALG_FARM_32, ALG_FARM_64, ALG_FARM_128,
    ALG_FARM_FP_32, ALG_FARM_FP_64, ALG_FARM_FP_128,
    ALG_METRO_64_1, ALG_METRO_64_2, ALG_METRO_128_1, ALG_METRO_128_2,
    ALG_METRO_64_CRC_1, ALG_METRO_64_CRC_2,
    ALG_METRO_128_CRC_1, ALG_METRO_128_CRC_2,
    ALG_MUM_64, ALG_T1HA2_ATONCE, ALG_T1HA2_ATONCE128,
    ALG_T1HA1_LE, ALG_T1HA1_BE,
};


static hv_t dispatch(int algo, const uint8_t *buf, size_t len, hv_t seed) {
    uint64_t s0 = seed.w[0];
    hv_t out = {{0, 0, 0, 0}};
    switch (algo) {
        case ALG_FNV1_32:        out.w[0] = fnv1_32(buf, len, (uint32_t)s0); break;
        case ALG_FNV1A_32:       out.w[0] = fnv1a_32(buf, len, (uint32_t)s0); break;
        case ALG_FNV1_64:        out.w[0] = fnv1_64(buf, len, s0); break;
        case ALG_FNV1A_64:       out.w[0] = fnv1a_64(buf, len, s0); break;
        case ALG_MURMUR2_32:     out.w[0] = murmur2_32(buf, len, (uint32_t)s0); break;
        case ALG_MURMUR2_X64_64A:out.w[0] = murmur2_x64_64a(buf, len, s0); break;
        case ALG_MURMUR3_32:     out.w[0] = murmur3_32(buf, len, (uint32_t)s0); break;
        case ALG_XX_32:          out.w[0] = xx_32(buf, len, (uint32_t)s0); break;
        case ALG_XX_64:          out.w[0] = xx_64(buf, len, s0); break;
        case ALG_SUPER_FAST:     out.w[0] = super_fast_hash(buf, len, (uint32_t)s0); break;
        case ALG_LOOKUP3_LITTLE: out.w[0] = lookup3_little(buf, len, (uint32_t)s0); break;
        case ALG_MURMUR1_32:     out.w[0] = murmur1_32(buf, len, (uint32_t)s0); break;
        case ALG_MURMUR2A_32:    out.w[0] = murmur2a_32(buf, len, (uint32_t)s0); break;
        case ALG_MURMUR2_X86_64B:out.w[0] = murmur2_x86_64b(buf, len, s0); break;
        case ALG_MURMUR3_X86_128: out = murmur3_x86_128(buf, len, (uint32_t)s0); break;
        case ALG_MURMUR3_X64_128: out = murmur3_x64_128(buf, len, (uint32_t)s0); break;
        case ALG_LOOKUP3_BIG:    out.w[0] = lookup3_big(buf, len, (uint32_t)s0); break;
        case ALG_CITY_32:        out.w[0] = city_32_with_seed(buf, len, (uint32_t)s0); break;
        case ALG_CITY_64:
            out.w[0] = s0 ? city_64_with_seeds(buf, len, CITY_K2, s0)
                          : city_64(buf, len);
            break;
        case ALG_CITY_128:       /* SSE4.2 reference path = CRC variant */
        case ALG_CITY_CRC_128:
            out = (seed.w[0] | seed.w[1])
                ? city_crc128_with_seed(buf, len, seed.w[0], seed.w[1])
                : city_crc128(buf, len);
            break;
        case ALG_CITY_FP_256: {
            uint64_t r[4];
            city_crc256(buf, len, r);
            out.w[0] = r[0]; out.w[1] = r[1]; out.w[2] = r[2]; out.w[3] = r[3];
            break;
        }
        case ALG_SPOOKY_32: {
            uint64_t h1 = (uint32_t)s0, h2 = (uint32_t)s0;
            spooky_hash128(buf, len, &h1, &h2);
            out.w[0] = (uint32_t)h1;
            break;
        }
        case ALG_SPOOKY_64: {
            uint64_t h1 = s0, h2 = s0;
            spooky_hash128(buf, len, &h1, &h2);
            out.w[0] = h1;
            break;
        }
        case ALG_SPOOKY_128: {
            uint64_t h1 = seed.w[0], h2 = seed.w[1];
            spooky_hash128(buf, len, &h1, &h2);
            out.w[0] = h1; out.w[1] = h2;
            break;
        }
        case ALG_FARM_32:
            out.w[0] = s0 ? farm_32_mk_with_seed(buf, len, (uint32_t)s0)
                          : farm_32_mk(buf, len);
            break;
        case ALG_FARM_64:
            out.w[0] = s0 ? farm_64_na_with_seeds(buf, len, CITY_K2, s0)
                          : farm_64_xo(buf, len);
            break;
        case ALG_FARM_128:
            out = (seed.w[0] | seed.w[1])
                ? farm_128_cc_with_seed(buf, len, seed.w[0], seed.w[1])
                : farm_128_cc(buf, len);
            break;
        case ALG_FARM_FP_32:     out.w[0] = farm_32_mk(buf, len); break;
        case ALG_FARM_FP_64:     out.w[0] = farm_64_na(buf, len); break;
        case ALG_FARM_FP_128:    out = farm_128_cc(buf, len); break;
        case ALG_METRO_64_1:     out.w[0] = metro_64(buf, len, (uint32_t)s0, 0); break;
        case ALG_METRO_64_2:     out.w[0] = metro_64(buf, len, (uint32_t)s0, 1); break;
        case ALG_METRO_128_1:    out = metro_128(buf, len, (uint32_t)s0, 0); break;
        case ALG_METRO_128_2:    out = metro_128(buf, len, (uint32_t)s0, 1); break;
        case ALG_METRO_64_CRC_1: out.w[0] = metro_64_crc(buf, len, (uint32_t)s0, 0); break;
        case ALG_METRO_64_CRC_2: out.w[0] = metro_64_crc(buf, len, (uint32_t)s0, 1); break;
        case ALG_METRO_128_CRC_1: out = metro_128_crc(buf, len, (uint32_t)s0, 0); break;
        case ALG_METRO_128_CRC_2: out = metro_128_crc(buf, len, (uint32_t)s0, 1); break;
        case ALG_MUM_64:         out.w[0] = mum_64(buf, len, s0); break;
        case ALG_T1HA2_ATONCE:   out.w[0] = t1ha2_atonce(buf, len, s0); break;
        case ALG_T1HA2_ATONCE128: out = t1ha2_atonce128(buf, len, s0); break;
        case ALG_T1HA1_LE:       out.w[0] = t1ha1_hash(buf, len, s0, 0); break;
        case ALG_T1HA1_BE:       out.w[0] = t1ha1_hash(buf, len, s0, 1); break;
    }
    return out;
}
typedef struct {
    const char *name;
    int algo;
    int val_bits;
    int seed_bits;   /* 0 = fingerprinter */
} algo_spec;

/* Mirrors the reference export surface (Hash.cpp:17-105). Notes:
 * - murmur{1,2}_aligned_32 and murmur2_neutral_32 produce identical values
 *   to their unaligned/endian-specific twins on little-endian hosts and
 *   share implementations here.
 * - city_128/city_crc_128 reproduce the SSE4.2 CRC path the reference takes
 *   on its published x86-64 builds (City.h runtime check).
 * - farm_32/farm_64 with seed 0 are pinned to the PORTABLE farmhash
 *   variants (mk/xo); the reference build dispatches to SSE4.1 variants
 *   that farmhash itself documents as non-portable.
 * - t1ha0 is the reference's runtime-dispatch name; pinned to t1ha2_atonce
 *   (the t1ha.h non-AES 64-bit LE mapping, t1ha.h:652). */
static algo_spec SPECS[] = {
    {"fnv1_32", ALG_FNV1_32, 32, 32},
    {"fnv1a_32", ALG_FNV1A_32, 32, 32},
    {"fnv1_64", ALG_FNV1_64, 64, 64},
    {"fnv1a_64", ALG_FNV1A_64, 64, 64},
    {"murmur1_32", ALG_MURMUR1_32, 32, 32},
    {"murmur1_aligned_32", ALG_MURMUR1_32, 32, 32},
    {"murmur2_32", ALG_MURMUR2_32, 32, 32},
    {"murmur2a_32", ALG_MURMUR2A_32, 32, 32},
    {"murmur2_aligned_32", ALG_MURMUR2_32, 32, 32},
    {"murmur2_neutral_32", ALG_MURMUR2_32, 32, 32},
    {"murmur2_x64_64a", ALG_MURMUR2_X64_64A, 64, 64},
    {"murmur2_x86_64b", ALG_MURMUR2_X86_64B, 64, 64},
    {"murmur3_32", ALG_MURMUR3_32, 32, 32},
    {"murmur3_x86_128", ALG_MURMUR3_X86_128, 128, 32},
    {"murmur3_x64_128", ALG_MURMUR3_X64_128, 128, 32},
    {"lookup3_little", ALG_LOOKUP3_LITTLE, 32, 32},
    {"lookup3_big", ALG_LOOKUP3_BIG, 32, 32},
    {"lookup3", ALG_LOOKUP3_LITTLE, 32, 32},   /* LE-host alias */
    {"super_fast_hash", ALG_SUPER_FAST, 32, 32},
    {"city_32", ALG_CITY_32, 32, 32},
    {"city_64", ALG_CITY_64, 64, 64},
    {"city_128", ALG_CITY_128, 128, 128},
    {"city_crc_128", ALG_CITY_CRC_128, 128, 128},
    {"city_fingerprint_256", ALG_CITY_FP_256, 256, 0},
    {"spooky_32", ALG_SPOOKY_32, 32, 32},
    {"spooky_64", ALG_SPOOKY_64, 64, 64},
    {"spooky_128", ALG_SPOOKY_128, 128, 128},
    {"farm_32", ALG_FARM_32, 32, 32},
    {"farm_64", ALG_FARM_64, 64, 64},
    {"farm_128", ALG_FARM_128, 128, 128},
    {"farm_fingerprint_32", ALG_FARM_FP_32, 32, 0},
    {"farm_fingerprint_64", ALG_FARM_FP_64, 64, 0},
    {"farm_fingerprint_128", ALG_FARM_FP_128, 128, 0},
    {"metro_64_1", ALG_METRO_64_1, 64, 32},
    {"metro_64_2", ALG_METRO_64_2, 64, 32},
    {"metro_128_1", ALG_METRO_128_1, 128, 32},
    {"metro_128_2", ALG_METRO_128_2, 128, 32},
    {"metro_64_crc_1", ALG_METRO_64_CRC_1, 64, 32},
    {"metro_64_crc_2", ALG_METRO_64_CRC_2, 64, 32},
    {"metro_128_crc_1", ALG_METRO_128_CRC_1, 128, 32},
    {"metro_128_crc_2", ALG_METRO_128_CRC_2, 128, 32},
    {"mum_64", ALG_MUM_64, 64, 64},
    {"t1ha2_atonce", ALG_T1HA2_ATONCE, 64, 64},
    {"t1ha2_atonce128", ALG_T1HA2_ATONCE128, 128, 64},
    {"t1ha1_le", ALG_T1HA1_LE, 64, 64},
    {"t1ha1_be", ALG_T1HA1_BE, 64, 64},
    {"t1ha0", ALG_T1HA2_ATONCE, 64, 64},
    {"t1ha", ALG_T1HA2_ATONCE, 64, 64},       /* legacy alias = t1ha2 */
    {"xx_32", ALG_XX_32, 32, 32},
    {"xx_64", ALG_XX_64, 64, 64},
    {NULL, 0, 0, 0}
};

/* ------------------------------------------------------------------ */
/* ctypes interface                                                    */
/* ------------------------------------------------------------------ */

void pyhashx_init(void) { crc32c_init(); }

int pyhashx_spec(int i, const char **name, int *algo, int *val_bits,
                 int *seed_bits) {
    if (i < 0 || i >= (int)(sizeof(SPECS) / sizeof(SPECS[0])) ||
        !SPECS[i].name)
        return 0;
    *name = SPECS[i].name;
    *algo = SPECS[i].algo;
    *val_bits = SPECS[i].val_bits;
    *seed_bits = SPECS[i].seed_bits;
    return 1;
}

void pyhashx_hash(int algo, const uint8_t *buf, size_t len,
                  const uint64_t seed[4], uint64_t out[4]) {
    hv_t s;
    memcpy(s.w, seed, sizeof(s.w));
    hv_t r = dispatch(algo, buf, len, s);
    memcpy(out, r.w, sizeof(r.w));
}

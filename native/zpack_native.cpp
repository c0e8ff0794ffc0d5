// zpack-tpu native host backend: XXH3-64 + LZ4 block codec.
//
// Role parity: the host-side compute the reference gets from its vendored
// xxHash/lz4 C libraries (lib/zpack_write.c:204-256, lib/zpack_read.c:414-466).
// Written from the public format specifications; independent implementation,
// bit-compatible with the Python/numpy and JAX paths in this repo.
//
// Build: g++ -O3 -march=native -shared -fPIC zpack_native.cpp -o _zpack_native.so
// Loaded via ctypes (zpack_tpu/native.py); pure-C ABI.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdlib>
#include <atomic>
#include <memory>
#include <thread>
#include <vector>

#include "zn_threads.h"

extern "C" {

// ---------------------------------------------------------------------------
// XXH3-64 (one-shot, seed 0) — public xxHash spec
// ---------------------------------------------------------------------------

static const uint8_t kSecret[192] = {
    0xb8,0xfe,0x6c,0x39,0x23,0xa4,0x4b,0xbe,0x7c,0x01,0x81,0x2c,0xf7,0x21,0xad,0x1c,
    0xde,0xd4,0x6d,0xe9,0x83,0x90,0x97,0xdb,0x72,0x40,0xa4,0xa4,0xb7,0xb3,0x67,0x1f,
    0xcb,0x79,0xe6,0x4e,0xcc,0xc0,0xe5,0x78,0x82,0x5a,0xd0,0x7d,0xcc,0xff,0x72,0x21,
    0xb8,0x08,0x46,0x74,0xf7,0x43,0x24,0x8e,0xe0,0x35,0x90,0xe6,0x81,0x3a,0x26,0x4c,
    0x3c,0x28,0x52,0xbb,0x91,0xc3,0x00,0xcb,0x88,0xd0,0x65,0x8b,0x1b,0x53,0x2e,0xa3,
    0x71,0x64,0x48,0x97,0xa2,0x0d,0xf9,0x4e,0x38,0x19,0xef,0x46,0xa9,0xde,0xac,0xd8,
    0xa8,0xfa,0x76,0x3f,0xe3,0x9c,0x34,0x3f,0xf9,0xdc,0xbb,0xc7,0xc7,0x0b,0x4f,0x1d,
    0x8a,0x51,0xe0,0x4b,0xcd,0xb4,0x59,0x31,0xc8,0x9f,0x7e,0xc9,0xd9,0x78,0x73,0x64,
    0xea,0xc5,0xac,0x83,0x34,0xd3,0xeb,0xc3,0xc5,0x81,0xa0,0xff,0xfa,0x13,0x63,0xeb,
    0x17,0x0d,0xdd,0x51,0xb7,0xf0,0xda,0x49,0xd3,0x16,0x55,0x26,0x29,0xd4,0x68,0x9e,
    0x2b,0x16,0xbe,0x58,0x7d,0x47,0xa1,0xfc,0x8f,0xf8,0xb8,0xd1,0x7a,0xd0,0x31,0xce,
    0x45,0xcb,0x3a,0x8f,0x95,0x16,0x04,0x28,0xaf,0xd7,0xfb,0xca,0xbb,0x4b,0x40,0x7e,
};

static const uint64_t P32_1 = 0x9E3779B1ULL;
static const uint64_t P32_2 = 0x85EBCA77ULL;
static const uint64_t P32_3 = 0xC2B2AE3DULL;
static const uint64_t P64_1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P64_2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P64_3 = 0x165667B19E3779F9ULL;
static const uint64_t P64_4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P64_5 = 0x27D4EB2F165667C5ULL;
static const uint64_t PMX1 = 0x165667919E3779F9ULL;
static const uint64_t PMX2 = 0x9FB21C651E98DF25ULL;

static inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t swap32v(uint32_t x) { return __builtin_bswap32(x); }
static inline uint64_t swap64v(uint64_t x) { return __builtin_bswap64(x); }

static inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
    __uint128_t p = ( __uint128_t )a * b;
    return (uint64_t)p ^ (uint64_t)(p >> 64);
}

static inline uint64_t avalanche64(uint64_t h) {
    h ^= h >> 33; h *= P64_2; h ^= h >> 29; h *= P64_3; h ^= h >> 32; return h;
}
static inline uint64_t avalanche3(uint64_t h) {
    h ^= h >> 37; h *= PMX1; h ^= h >> 32; return h;
}

static inline uint64_t mix16(const uint8_t* d, const uint8_t* s) {
    return mul128_fold64(rd64(d) ^ rd64(s), rd64(d + 8) ^ rd64(s + 8));
}

static uint64_t xxh3_short(const uint8_t* d, size_t len) {
    if (len > 16) {
        if (len <= 128) {
            uint64_t acc = len * P64_1;
            if (len > 32) {
                if (len > 64) {
                    if (len > 96) {
                        acc += mix16(d + 48, kSecret + 96);
                        acc += mix16(d + len - 64, kSecret + 112);
                    }
                    acc += mix16(d + 32, kSecret + 64);
                    acc += mix16(d + len - 48, kSecret + 80);
                }
                acc += mix16(d + 16, kSecret + 32);
                acc += mix16(d + len - 32, kSecret + 48);
            }
            acc += mix16(d, kSecret);
            acc += mix16(d + len - 16, kSecret + 16);
            return avalanche3(acc);
        }
        // 129..240
        uint64_t acc = len * P64_1;
        size_t nb = len / 16;
        for (int i = 0; i < 8; i++) acc += mix16(d + 16 * i, kSecret + 16 * i);
        acc = avalanche3(acc);
        for (size_t i = 8; i < nb; i++) acc += mix16(d + 16 * i, kSecret + 16 * (i - 8) + 3);
        acc += mix16(d + len - 16, kSecret + 136 - 17);
        return avalanche3(acc);
    }
    if (len > 8) {
        uint64_t bf1 = rd64(kSecret + 24) ^ rd64(kSecret + 32);
        uint64_t bf2 = rd64(kSecret + 40) ^ rd64(kSecret + 48);
        uint64_t lo = rd64(d) ^ bf1;
        uint64_t hi = rd64(d + len - 8) ^ bf2;
        uint64_t acc = len + swap64v(lo) + hi + mul128_fold64(lo, hi);
        return avalanche3(acc);
    }
    if (len >= 4) {
        uint64_t in1 = rd32(d), in2 = rd32(d + len - 4);
        uint64_t bf = rd64(kSecret + 8) ^ rd64(kSecret + 16);
        uint64_t keyed = (in2 + (in1 << 32)) ^ bf;
        uint64_t h = keyed ^ rotl64(keyed, 49) ^ rotl64(keyed, 24);
        h *= PMX2;
        h ^= (h >> 35) + len;
        h *= PMX2;
        h ^= h >> 28;
        return h;
    }
    if (len > 0) {
        uint32_t c1 = d[0], c2 = d[len >> 1], c3 = d[len - 1];
        uint32_t comb = (c1 << 16) | (c2 << 24) | c3 | ((uint32_t)len << 8);
        uint64_t bf = (uint64_t)(rd32(kSecret) ^ rd32(kSecret + 4));
        return avalanche64(comb ^ bf);
    }
    return avalanche64(rd64(kSecret + 56) ^ rd64(kSecret + 64));
}

static inline void accum512(uint64_t* acc, const uint8_t* d, const uint8_t* sec) {
    for (int i = 0; i < 8; i++) {
        uint64_t dv = rd64(d + 8 * i);
        uint64_t dk = dv ^ rd64(sec + 8 * i);
        acc[i ^ 1] += dv;
        acc[i] += (dk & 0xFFFFFFFFULL) * (dk >> 32);
    }
}

uint64_t zn_xxh3_64(const uint8_t* d, size_t len) {
    if (len <= 240) return xxh3_short(d, len);
    uint64_t acc[8] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
    const size_t stripes_per_block = 16, block_len = 1024;
    size_t nb_blocks = (len - 1) / block_len;
    for (size_t b = 0; b < nb_blocks; b++) {
        const uint8_t* base = d + b * block_len;
        for (size_t s = 0; s < stripes_per_block; s++)
            accum512(acc, base + 64 * s, kSecret + 8 * s);
        for (int i = 0; i < 8; i++) {
            uint64_t a = acc[i];
            a ^= a >> 47;
            a ^= rd64(kSecret + 192 - 64 + 8 * i);
            acc[i] = a * P32_1;
        }
    }
    size_t done = nb_blocks * block_len;
    size_t nb_stripes = ((len - 1) - done) / 64;
    for (size_t s = 0; s < nb_stripes; s++)
        accum512(acc, d + done + 64 * s, kSecret + 8 * s);
    accum512(acc, d + len - 64, kSecret + 192 - 64 - 7);
    uint64_t result = len * P64_1;
    for (int i = 0; i < 4; i++)
        result += mul128_fold64(acc[2 * i] ^ rd64(kSecret + 11 + 16 * i),
                                acc[2 * i + 1] ^ rd64(kSecret + 11 + 16 * i + 8));
    return avalanche3(result);
}

// ---------------------------------------------------------------------------
// LZ4 block codec — public LZ4 block format
// ---------------------------------------------------------------------------

#define LZ4_MINMATCH 4
#define LZ4_MFLIMIT 12
#define LZ4_LASTLITS 5
#define HASH_LOG 16

static inline uint32_t lz4_hash(uint32_t v) { return (v * 2654435761U) >> (32 - HASH_LOG); }

static inline uint8_t* write_lsic(uint8_t* op, size_t v) {
    while (v >= 255) { *op++ = 255; v -= 255; }
    *op++ = (uint8_t)v;
    return op;
}

// Emit one sequence (literals + match). Returns NULL on output overflow.
static inline uint8_t* lz4_emit(uint8_t* op, uint8_t* oend, const uint8_t* src,
                                size_t lit_start, size_t ll, size_t off, size_t ml) {
    size_t need = 1 + ll / 255 + 1 + ll + 2 + ml / 255 + 1;
    if (op + need > oend) return NULL;
    size_t mlc = ml - LZ4_MINMATCH;
    *op++ = (uint8_t)(((ll < 15 ? ll : 15) << 4) | (mlc < 15 ? mlc : 15));
    if (ll >= 15) op = write_lsic(op, ll - 15);
    memcpy(op, src + lit_start, ll); op += ll;
    *op++ = (uint8_t)off; *op++ = (uint8_t)(off >> 8);
    if (mlc >= 15) op = write_lsic(op, mlc - 15);
    return op;
}

#define HASH_LOG_FAST 13
static inline uint32_t lz4_hash_fast(uint32_t v) { return (v * 2654435761U) >> (32 - HASH_LOG_FAST); }

// Fast greedy path for blocks whose positions fit in 16 bits (the 64 KiB
// frame block size): L1-resident u16 hash table storing pos+1 (0 = empty).
static size_t lz4_compress_fast64k(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    static thread_local uint16_t table[1 << HASH_LOG_FAST];
    memset(table, 0, sizeof(table));
    size_t lit_start = 0;
    size_t pos = 1;
    size_t mflimit = n - LZ4_MFLIMIT;
    size_t limit = n - LZ4_LASTLITS;
    table[lz4_hash_fast(rd32(src))] = 1;
    size_t attempts = 1u << 6;  // lz4 skip-trigger acceleration
    while (pos < mflimit) {
        uint32_t v = rd32(src + pos);
        uint32_t h = lz4_hash_fast(v);
        uint32_t cand1 = table[h];
        table[h] = (uint16_t)(pos + 1);
        if (cand1 && rd32(src + cand1 - 1) == v) {
            size_t cand = cand1 - 1;
            size_t ml = LZ4_MINMATCH;
            size_t maxml = limit - pos;
            while (ml + 8 <= maxml && rd64(src + cand + ml) == rd64(src + pos + ml)) ml += 8;
            while (ml < maxml && src[cand + ml] == src[pos + ml]) ml++;
            // extend backwards into pending literals
            while (pos > lit_start && cand > 0 && src[pos - 1] == src[cand - 1]) {
                pos--; cand--; ml++;
            }
            op = lz4_emit(op, oend, src, lit_start, pos - lit_start, pos - cand, ml);
            if (!op) return (size_t)-1;
            pos += ml;
            lit_start = pos;
            if (pos < mflimit) {
                table[lz4_hash_fast(rd32(src + pos - 2))] = (uint16_t)(pos - 1);
            }
            attempts = 1u << 6;
            continue;
        }
        pos += attempts++ >> 6;  // step grows every 64 failed probes
    }
    // final literals
    size_t ll = n - lit_start;
    size_t need = 1 + ll / 255 + 1 + ll;
    if (op + need > oend) return (size_t)-1;
    *op++ = (uint8_t)((ll < 15 ? ll : 15) << 4);
    if (ll >= 15) op = write_lsic(op, ll - 15);
    memcpy(op, src + lit_start, ll);
    op += ll;
    return (size_t)(op - dst);
}

// Greedy hash-table encoder; level>=3 walks a hash chain (HC-style).
size_t zn_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, int level) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    if (n == 0) return 0;
    if (level <= 2 && n >= LZ4_MFLIMIT + 1 && n <= (1u << 16))
        return lz4_compress_fast64k(src, n, dst, cap);
    size_t lit_start = 0;
    if (n >= LZ4_MFLIMIT + 1) {
        static thread_local int32_t table[1 << HASH_LOG];
        static thread_local int32_t chain[1 << 16];
        int depth = level <= 2 ? 1 : level <= 6 ? 1 << (level - 1) : level <= 9 ? 64 : 256;
        memset(table, 0xFF, sizeof(table));   // -1 sentinel in every slot
        if (depth > 1) memset(chain, 0xFF, sizeof(chain));
        size_t pos = 1;
        size_t mflimit = n - LZ4_MFLIMIT;
        size_t limit = n - LZ4_LASTLITS;
        // seed position 0
        table[lz4_hash(rd32(src))] = 0;
        size_t attempts = 1u << 6;  // lz4 skip-trigger acceleration
        while (pos < mflimit) {
            uint32_t h = lz4_hash(rd32(src + pos));
            int32_t cand = table[h];
            if (depth > 1) chain[pos & 0xFFFF] = cand;
            table[h] = (int32_t)pos;
            size_t best_ml = 0;
            size_t best_cand = 0;
            int d = depth;
            while (cand >= 0 && d-- > 0 && pos - (size_t)cand <= 65535) {
                if ((size_t)cand < pos && rd32(src + cand) == rd32(src + pos)) {
                    size_t ml = LZ4_MINMATCH;
                    size_t maxml = limit - pos;
                    while (ml + 8 <= maxml && rd64(src + cand + ml) == rd64(src + pos + ml)) ml += 8;
                    while (ml < maxml && src[cand + ml] == src[pos + ml]) ml++;
                    if (ml > best_ml) { best_ml = ml; best_cand = (size_t)cand; }
                }
                if (depth <= 1) break;
                int32_t nxt = chain[cand & 0xFFFF];
                if (nxt >= cand) break;
                cand = nxt;
            }
            if (best_ml >= LZ4_MINMATCH) {
                size_t ml = best_ml;
                size_t cand2 = best_cand;
                // extend backwards into pending literals
                while (pos > lit_start && cand2 > 0 && src[pos - 1] == src[cand2 - 1]) {
                    pos--; cand2--; ml++;
                }
                op = lz4_emit(op, oend, src, lit_start, pos - lit_start, pos - cand2, ml);
                if (!op) return (size_t)-1;
                // insert positions inside the match for future matches
                size_t end_pos = pos + ml;
                size_t step_in = depth > 1 ? 1 : 3;
                for (size_t q = pos + 1; q < end_pos && q < mflimit; q += step_in) {
                    uint32_t hq = lz4_hash(rd32(src + q));
                    if (depth > 1) chain[q & 0xFFFF] = table[hq];
                    table[hq] = (int32_t)q;
                }
                pos = end_pos;
                lit_start = pos;
                attempts = 1u << 6;
                continue;
            }
            pos += attempts++ >> 6;  // step grows every 64 failed probes
        }
    }
    // final literals
    size_t ll = n - lit_start;
    size_t need = 1 + ll / 255 + 1 + ll;
    if (op + need > oend) return (size_t)-1;
    *op++ = (uint8_t)((ll < 15 ? ll : 15) << 4);
    if (ll >= 15) op = write_lsic(op, ll - 15);
    memcpy(op, src + lit_start, ll);
    op += ll;
    return (size_t)(op - dst);
}

// Decode with optional linked-block prefix (history). Returns output length
// or (size_t)-1 on malformed input / overflow.
size_t zn_lz4_decompress(const uint8_t* src, size_t n,
                         uint8_t* dst, size_t cap,
                         const uint8_t* prefix, size_t prefix_len) {
    // pattern-expansion tables for overlapping (offset < 8) match copies
    static const unsigned inc32tab[8] = {0, 1, 2, 1, 0, 4, 4, 4};
    static const int dec64tab[8] = {0, 0, 0, -1, -4, 1, 2, 3};
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    // fast-loop bounds: enough slack that 16/32-byte wildcopies cannot
    // scribble past either buffer end
    const uint8_t* ifast = n >= 32 ? iend - 32 : src;
    uint8_t* ofast = cap >= 64 ? oend - 64 : dst;
    while (ip < iend) {
        uint8_t tok = *ip++;
        size_t ll = tok >> 4;
        if (ip < ifast && op < ofast) {
            // --- fast path: wildcopies, minimal per-sequence branching ---
            if (ll < 15) {
                memcpy(op, ip, 16);  // ll <= 14; 32B input slack, 64B output slack
                op += ll; ip += ll;
            } else {
                uint8_t c;
                do { if (ip >= iend) return (size_t)-1; c = *ip++; ll += c; } while (c == 255);
                if ((size_t)(iend - ip) < ll || (size_t)(oend - op) < ll) return (size_t)-1;
                memcpy(op, ip, ll); op += ll; ip += ll;
            }
            if (ip >= iend) break;  // last sequence: literals only
            if (iend - ip < 2) return (size_t)-1;
            size_t off = ip[0] | ((size_t)ip[1] << 8);
            ip += 2;
            if (off == 0) return (size_t)-1;
            size_t ml = (tok & 0xF) + LZ4_MINMATCH;
            if ((tok & 0xF) == 15) {
                uint8_t c;
                do { if (ip >= iend) return (size_t)-1; c = *ip++; ml += c; } while (c == 255);
            }
            size_t produced = (size_t)(op - dst);
            if (off <= produced && op + ml <= ofast) {
                const uint8_t* mp = op - off;
                uint8_t* cpend = op + ml;
                if (off >= 16) {
                    do { memcpy(op, mp, 16); op += 16; mp += 16; } while (op < cpend);
                } else if (off >= 8) {
                    memcpy(op, mp, 8); memcpy(op + 8, mp + 8, 8);
                    op += 16; mp += 16;
                    while (op < cpend) { memcpy(op, mp, 8); op += 8; mp += 8; }
                } else {
                    op[0] = mp[0]; op[1] = mp[1]; op[2] = mp[2]; op[3] = mp[3];
                    mp += inc32tab[off];
                    memcpy(op + 4, mp, 4);
                    mp -= dec64tab[off];
                    op += 8;
                    while (op < cpend) { memcpy(op, mp, 8); op += 8; mp += 8; }
                }
                op = cpend;
                continue;
            }
            // rare: prefix-crossing match or near output end — safe copy below
            if ((size_t)(oend - op) < ml) return (size_t)-1;
            if (off > produced + prefix_len) return (size_t)-1;
            if (off <= produced) {
                const uint8_t* mp = op - off;
                for (size_t i = 0; i < ml; i++) op[i] = mp[i];
                op += ml;
            } else {
                size_t from_prefix = off - produced;
                const uint8_t* pp = prefix + prefix_len - from_prefix;
                size_t take = from_prefix < ml ? from_prefix : ml;
                memcpy(op, pp, take); op += take;
                size_t rest = ml - take;
                const uint8_t* mp = op - off;
                for (size_t i = 0; i < rest; i++) op[i] = mp[i];
                op += rest;
            }
            continue;
        }
        // --- safe path (near either buffer end): exact bounds checks ---
        if (ll == 15) {
            uint8_t c;
            do { if (ip >= iend) return (size_t)-1; c = *ip++; ll += c; } while (c == 255);
        }
        if ((size_t)(iend - ip) < ll || (size_t)(oend - op) < ll) return (size_t)-1;
        memcpy(op, ip, ll); op += ll; ip += ll;
        if (ip == iend) break;  // last sequence: literals only
        if (iend - ip < 2) return (size_t)-1;
        size_t off = ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (off == 0) return (size_t)-1;
        size_t ml = (tok & 0xF) + LZ4_MINMATCH;
        if ((tok & 0xF) == 15) {
            uint8_t c;
            do { if (ip >= iend) return (size_t)-1; c = *ip++; ml += c; } while (c == 255);
        }
        if ((size_t)(oend - op) < ml) return (size_t)-1;
        size_t produced = (size_t)(op - dst);
        if (off > produced + prefix_len) return (size_t)-1;
        if (off <= produced) {
            const uint8_t* mp = op - off;
            for (size_t i = 0; i < ml; i++) op[i] = mp[i];
            op += ml;
        } else {
            // match starts in the prefix (linked blocks)
            size_t from_prefix = off - produced;
            const uint8_t* pp = prefix + prefix_len - from_prefix;
            size_t take = from_prefix < ml ? from_prefix : ml;
            memcpy(op, pp, take); op += take;
            size_t rest = ml - take;
            const uint8_t* mp = op - off;
            for (size_t i = 0; i < rest; i++) op[i] = mp[i];
            op += rest;
        }
    }
    return (size_t)(op - dst);
}

}  // extern "C"  (templates cannot have C linkage)

// Serialize LZ4 frame-block sections from DEVICE match tables: the device
// tokenizer (zpack_tpu/kernels/lz4_jax.py) finds per-position
// (src, mlen<=16-capped) candidates; this does the greedy parse, exact
// forward/backward extension, byte emission and the compressed-vs-raw
// decision for nb consecutive blocks of bsz bytes, in parallel.  Each
// block section is a 4-byte LE size header (high bit = uncompressed)
// followed by the payload — the lz4f frame body minus header/end-mark.
// Role parity: the serialization half of LZ4_compress_default that the
// reference gets via lib/zpack_write.c:204-211.
// The match tables arrive in whichever packing the device kernel ships
// (int32 pair / u16 token / u16+u8 pair — see kernels/lz4_jax.py); Fetch
// decodes one position so no host-side unpack pass ever materializes the
// 8-byte-per-byte int32 tables (that pass was the non-scaling host stage
// flagged by the round-2 scaling measurements).
// Returns total bytes written or (size_t)-1 (cap too small / bad tables).
template <class Fetch>
static size_t zn_lz4_serialize_blocks_core(const uint8_t* data, size_t n,
                                           size_t bsz, size_t nb, uint8_t* dst,
                                           size_t cap, Fetch fetch) {
    if (nb == 0 || bsz == 0 || n == 0) return 0;
    std::vector<std::vector<uint8_t>> outs(nb);
    std::atomic<bool> bad{false};
    unsigned nt = zn_nthreads();
    zn_parallel_for(nb, nt, [&](size_t i) {
        size_t off0 = i * bsz;
        if (off0 >= n) { return; }
        const uint8_t* d = data + off0;
        size_t cl = n - off0 < bsz ? n - off0 : bsz;
        std::vector<uint8_t>& ob = outs[i];
        ob.resize(4 + cl + cl / 255 + 16);
        uint8_t* op = ob.data() + 4;
        uint8_t* oend = ob.data() + ob.size();
        size_t limit = cl > LZ4_LASTLITS ? cl - LZ4_LASTLITS : 0;
        size_t mflim = cl > LZ4_MFLIMIT ? cl - LZ4_MFLIMIT : 0;
        size_t lit = 0;
        for (size_t p = 1; p < mflim;) {
            int32_t m, j;
            fetch(i, p, &j, &m);
            if (m < LZ4_MINMATCH || j < 0 || (size_t)j >= p || p - (size_t)j > 65535) {
                p++;
                continue;
            }
            size_t e = (size_t)m;
            if (p + e > limit) e = limit - p;
            while (p + e < limit && d[p + e] == d[(size_t)j + e]) e++;
            if (e < LZ4_MINMATCH) { p++; continue; }
            size_t pp = p, jj = (size_t)j;
            while (pp > lit && jj > 0 && d[pp - 1] == d[jj - 1]) { pp--; jj--; e++; }
            op = lz4_emit(op, oend, d, lit, pp - lit, pp - jj, e);
            if (!op) { bad.store(true); return; }
            p = pp + e;
            lit = p;
        }
        size_t ll = cl - lit;
        size_t need = 1 + ll / 255 + 1 + ll;
        if (op + need > oend) { bad.store(true); return; }
        *op++ = (uint8_t)((ll < 15 ? ll : 15) << 4);
        if (ll >= 15) op = write_lsic(op, ll - 15);
        memcpy(op, d + lit, ll);
        op += ll;
        size_t csz = (size_t)(op - (ob.data() + 4));
        if (csz >= cl) {
            // raw block wins: size header with the high bit set + the data
            ob.resize(4 + cl);
            uint32_t hdr = (uint32_t)cl | 0x80000000u;
            memcpy(ob.data(), &hdr, 4);
            memcpy(ob.data() + 4, d, cl);
        } else {
            uint32_t hdr = (uint32_t)csz;
            memcpy(ob.data(), &hdr, 4);
            ob.resize(4 + csz);
        }
    });
    if (bad.load()) return (size_t)-1;
    size_t total = 0;
    for (auto& ob : outs) total += ob.size();
    if (total > cap) return (size_t)-1;
    uint8_t* op = dst;
    for (auto& ob : outs) { memcpy(op, ob.data(), ob.size()); op += ob.size(); }
    return total;
}

extern "C" {

size_t zn_lz4_serialize_blocks(const uint8_t* data, size_t n, size_t bsz,
                               const int32_t* srct, const int32_t* mlent,
                               size_t nb, uint8_t* dst, size_t cap) {
    return zn_lz4_serialize_blocks_core(
        data, n, bsz, nb, dst, cap,
        [&](size_t i, size_t p, int32_t* j, int32_t* m) {
            *j = srct[i * bsz + p];
            *m = mlent[i * bsz + p];
        });
}

// u16 token rows from tokenize_block_u16: (src << 3) | (mlen - 3), 0 = none.
size_t zn_lz4_serialize_blocks_u16(const uint8_t* data, size_t n, size_t bsz,
                                   const uint16_t* tok, size_t nb,
                                   uint8_t* dst, size_t cap) {
    return zn_lz4_serialize_blocks_core(
        data, n, bsz, nb, dst, cap,
        [&](size_t i, size_t p, int32_t* j, int32_t* m) {
            uint16_t t = tok[i * bsz + p];
            int32_t code = t & 7;
            *m = code ? code + 3 : 0;
            *j = code ? (int32_t)(t >> 3) : -1;
        });
}

// (src u16, code u8) rows from tokenize_block_resort: code = mlen - 3.
size_t zn_lz4_serialize_blocks_pair(const uint8_t* data, size_t n, size_t bsz,
                                    const uint16_t* srct, const uint8_t* codet,
                                    size_t nb, uint8_t* dst, size_t cap) {
    return zn_lz4_serialize_blocks_core(
        data, n, bsz, nb, dst, cap,
        [&](size_t i, size_t p, int32_t* j, int32_t* m) {
            int32_t code = codet[i * bsz + p];
            *m = code ? code + 3 : 0;
            *j = code ? (int32_t)srct[i * bsz + p] : -1;
        });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// XXH32 (LZ4 frame header/content checksums) + LZ4 frame codec
// ---------------------------------------------------------------------------

extern "C" {

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

uint32_t zn_xxh32(const uint8_t* d, size_t len, uint32_t seed) {
    const uint32_t P1 = 0x9E3779B1u, P2 = 0x85EBCA77u, P3 = 0xC2B2AE3Du,
                   P4 = 0x27D4EB2Fu, P5 = 0x165667B1u;
    size_t pos = 0;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        while (pos + 16 <= len) {
            v1 = rotl32(v1 + rd32(d + pos) * P2, 13) * P1;
            v2 = rotl32(v2 + rd32(d + pos + 4) * P2, 13) * P1;
            v3 = rotl32(v3 + rd32(d + pos + 8) * P2, 13) * P1;
            v4 = rotl32(v4 + rd32(d + pos + 12) * P2, 13) * P1;
            pos += 16;
        }
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (pos + 4 <= len) { h = rotl32(h + rd32(d + pos) * P3, 17) * P4; pos += 4; }
    while (pos < len) { h = rotl32(h + d[pos] * P5, 11) * P1; pos += 1; }
    h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
    return h;
}

// 5-byte hash (liblz4's byU32 strategy): longer distinguishing prefix ->
// the single stored candidate extends further on text.  13 hash bits keep
// the hot table slice L1-resident (32 KiB of i32): vs 16 bits that is
// +25% encode speed for +0.08% size.
#define LINKED_HASH_LOG 13
static inline uint32_t lz4h5(const uint8_t* p) {
    return (uint32_t)(((rd64(p) << 24) * 889523592379ULL) >> (64 - LINKED_HASH_LOG));
}

// First mismatching byte between p and m, scanning 8 bytes at a time with
// xor+ctz (the byte loop only runs in the sub-8 tail near `lim`).
static inline size_t lz4_count(const uint8_t* p, const uint8_t* m, const uint8_t* lim) {
    const uint8_t* s = p;
    while (p + 8 <= lim) {
        uint64_t d = rd64(p) ^ rd64(m);
        if (d) return (size_t)(p - s) + ((size_t)__builtin_ctzll(d) >> 3);
        p += 8; m += 8;
    }
    while (p < lim && *p == *m) { p++; m++; }
    return (size_t)(p - s);
}

// Greedy linked-block matcher for one 64 KiB block: absolute positions over
// the whole frame source, so matches reach up to 65535 bytes into earlier
// blocks (liblz4's default blockMode).  Speed-of-light single-thread loop:
// xor+ctz match counting, 8-byte wildcopy literal emission with NO
// per-sequence bounds checks (dst MUST have (bend-start) + (bend-start)/255
// + 80 bytes of writable slack — callers use padded scratch), hash inserts
// only at match-end-2 plus an immediate zero-literal retry at match end
// (the policy that makes liblz4's fast level fast).  Sequences still end
// inside the block (frame decodes block-by-block into rolling history).
static size_t lz4_block_linked_greedy(const uint8_t* base, size_t start,
                                      size_t bend, uint8_t* dst, bool warm) {
    static thread_local int32_t table[1 << LINKED_HASH_LOG];
    uint8_t* op = dst;
    size_t n = bend - start;
    if (n == 0) return 0;
    if (!warm) memset(table, 0xFF, sizeof(table));
    size_t lit_start = start;
    if (n >= LZ4_MFLIMIT + 1) {
        size_t pos = start;
        const size_t mflimit = bend - LZ4_MFLIMIT;
        const uint8_t* mlim = base + (bend - LZ4_LASTLITS);
        table[lz4h5(base + pos)] = (int32_t)pos;
        pos++;
        size_t attempts = 1u << 6;
        while (pos < mflimit) {
            uint32_t h = lz4h5(base + pos);
            int32_t cand = table[h];
            table[h] = (int32_t)pos;
            // pos - cand - 1 < 65535 enforces BOTH cand < pos (the retry
            // path below stores the CURRENT pos before breaking back here —
            // a self-match at offset 0 would be malformed) and offset<=65535
            if (!(cand >= 0 && pos - (size_t)cand - 1 < 65535 &&
                  rd32(base + cand) == rd32(base + pos))) {
                pos += attempts++ >> 6;  // step grows every 64 failed probes
                continue;
            }
            attempts = 1u << 6;
            size_t mpos = (size_t)cand;
            for (;;) {
                // backward extension into pending literals (no-op on the
                // immediate-retry iterations where pos == lit_start)
                while (pos > lit_start && mpos > 0 && base[pos - 1] == base[mpos - 1]) {
                    pos--; mpos--;
                }
                size_t ll = pos - lit_start;
                uint8_t* tok = op++;
                if (ll < 15) {
                    *tok = (uint8_t)(ll << 4);
                } else {
                    *tok = 0xF0;
                    op = write_lsic(op, ll - 15);
                }
                {   // literal wildcopy, 8-byte strides (reads stay < bend-4:
                    // lit end == pos < mflimit == bend-12)
                    const uint8_t* lp = base + lit_start;
                    uint8_t* lo = op;
                    uint8_t* le = op + ll;
                    do { memcpy(lo, lp, 8); lo += 8; lp += 8; } while (lo < le);
                    op = le;
                }
                size_t off = pos - mpos;
                *op++ = (uint8_t)off; *op++ = (uint8_t)(off >> 8);
                size_t mlc = lz4_count(base + pos + LZ4_MINMATCH,
                                       base + mpos + LZ4_MINMATCH, mlim);
                if (mlc < 15) {
                    *tok |= (uint8_t)mlc;
                } else {
                    *tok |= 15;
                    op = write_lsic(op, mlc - 15);
                }
                pos += mlc + LZ4_MINMATCH;
                lit_start = pos;
                if (pos >= mflimit) goto last_literals;
                table[lz4h5(base + pos - 2)] = (int32_t)(pos - 2);
                // immediate retry at the match end: a hit here emits a
                // zero-literal sequence without re-entering the skip loop.
                // pos - c2 - 1 < 65535 enforces BOTH c2 < pos (an earlier
                // search position can equal the new pos after backward
                // extension — offset 0 would be malformed) and offset<=65535.
                uint32_t h2 = lz4h5(base + pos);
                int32_t c2 = table[h2];
                table[h2] = (int32_t)pos;
                if (!(c2 >= 0 && pos - (size_t)c2 - 1 < 65535 &&
                      rd32(base + c2) == rd32(base + pos)))
                    break;
                mpos = (size_t)c2;
            }
        }
    }
last_literals:
    {
        size_t ll = bend - lit_start;
        *op++ = (uint8_t)((ll < 15 ? ll : 15) << 4);
        if (ll >= 15) op = write_lsic(op, ll - 15);
        memcpy(op, base + lit_start, ll);
        op += ll;
    }
    return (size_t)(op - dst);
}

// Compress one 64 KiB block of a LINKED-block frame — HC path (level>=3,
// chain walk; used by the depth>1 levels only; level<=2 routes to
// lz4_block_linked_greedy above).  The thread_local tables stay warm across
// a thread's contiguous block range (`warm`): only one cold start per
// thread instead of per block, which is what keeps the parallel path at
// independent-block speed.  Sequences still end inside the block (the
// frame format decodes block-by-block into a rolling 64 KiB history).
static size_t lz4_compress_block_linked(const uint8_t* base, size_t start,
                                        size_t bend, uint8_t* dst, size_t cap,
                                        int level, bool warm) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    size_t n = bend - start;
    if (n == 0) return 0;
    static thread_local int32_t table[1 << HASH_LOG];
    static thread_local int32_t chain[1 << 16];
    int depth = level <= 2 ? 1 : level <= 6 ? 1 << (level - 1) : level <= 9 ? 64 : 256;
    if (!warm) {
        memset(table, 0xFF, sizeof(table));
        if (depth > 1) memset(chain, 0xFF, sizeof(chain));
    }
    size_t lit_start = start;
    if (n >= LZ4_MFLIMIT + 1) {
        size_t pos = start;
        size_t mflimit = bend - LZ4_MFLIMIT;
        size_t limit = bend - LZ4_LASTLITS;
        // Same 5-byte hash as the greedy path (see lz4h5 above); reads are
        // safe: pos < mflimit = bend - 12.
        auto h5 = [&](size_t p) -> uint32_t { return lz4h5(base + p); };
        table[h5(pos)] = (int32_t)pos;
        pos++;
        size_t attempts = 1u << 6;
        while (pos < mflimit) {
            uint32_t h = h5(pos);
            int32_t cand = table[h];
            if (depth > 1) chain[pos & 0xFFFF] = cand;
            table[h] = (int32_t)pos;
            size_t best_ml = 0;
            size_t best_cand = 0;
            int d = depth;
            while (cand >= 0 && d-- > 0 && pos - (size_t)cand <= 65535) {
                if ((size_t)cand < pos && rd32(base + cand) == rd32(base + pos)) {
                    size_t ml = LZ4_MINMATCH;
                    size_t maxml = limit - pos;
                    while (ml + 8 <= maxml && rd64(base + cand + ml) == rd64(base + pos + ml)) ml += 8;
                    while (ml < maxml && base[cand + ml] == base[pos + ml]) ml++;
                    if (ml > best_ml) { best_ml = ml; best_cand = (size_t)cand; }
                }
                if (depth <= 1) break;
                int32_t nxt = chain[cand & 0xFFFF];
                if (nxt >= cand) break;
                cand = nxt;
            }
            if (best_ml >= LZ4_MINMATCH) {
                size_t ml = best_ml;
                size_t cand2 = best_cand;
                while (pos > lit_start && cand2 > 0 && base[pos - 1] == base[cand2 - 1]) {
                    pos--; cand2--; ml++;
                }
                op = lz4_emit(op, oend, base, lit_start, pos - lit_start, pos - cand2, ml);
                if (!op) return (size_t)-1;
                size_t end_pos = pos + ml;
                size_t step_in = depth > 1 ? 1 : 3;
                for (size_t q = pos + 1; q < end_pos && q < mflimit; q += step_in) {
                    uint32_t hq = h5(q);
                    if (depth > 1) chain[q & 0xFFFF] = table[hq];
                    table[hq] = (int32_t)q;
                }
                pos = end_pos;
                lit_start = pos;
                attempts = 1u << 6;
                continue;
            }
            pos += attempts++ >> 6;
        }
    }
    size_t ll = bend - lit_start;
    size_t need = 1 + ll / 255 + 1 + ll;
    if (op + need > oend) return (size_t)-1;
    *op++ = (uint8_t)((ll < 15 ? ll : 15) << 4);
    if (ll >= 15) op = write_lsic(op, ll - 15);
    memcpy(op, base + lit_start, ll);
    op += ll;
    return (size_t)(op - dst);
}

// One-shot lz4 frame compress: LINKED 64KiB blocks (liblz4's default mode,
// ~10% smaller than independent on compressible data), no checksums.
// Parallelism: contiguous block RANGES per thread, each range compressed
// sequentially with a warm match table — one cold start per thread.
// Returns size or (size_t)-1.
size_t zn_lz4f_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, int level) {
    const size_t BS = 64 << 10;
    if (n >= (1ULL << 30)) {
        // int32 position tables: segment giant direct calls into 1 GiB
        // frames (spec-valid concatenation; the archive codec path already
        // chunks at 2 MiB, this guards the public one-shot entry point)
        size_t total = 0;
        for (size_t off = 0; off < n; off += (1ULL << 30)) {
            size_t seg = n - off < (1ULL << 30) ? n - off : (1ULL << 30);
            size_t r = zn_lz4f_compress(src + off, seg, dst + total, cap - total, level);
            if (r == (size_t)-1) return (size_t)-1;
            total += r;
        }
        return total;
    }
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    if (cap < 15 + 4) return (size_t)-1;
    // magic + FLG(0x48: v01 + B.Linked + ContentSize) + BD(0x40: 64KB)
    // + u64 content size + HC.  The declared size lets concatenated
    // frames decode in parallel (each frame's output slot is known).
    op[0] = 0x04; op[1] = 0x22; op[2] = 0x4D; op[3] = 0x18;
    op[4] = 0x48; op[5] = 0x40;
    uint64_t csz64 = (uint64_t)n;
    memcpy(op + 6, &csz64, 8);
    op[14] = (uint8_t)(zn_xxh32(op + 4, 10, 0) >> 8);
    op += 15;
    size_t nb = (n + BS - 1) / BS;
    // internal range-parallelism only for big single calls: the chunked
    // codec path (one frame per 2 MiB) already parallelizes across frames
    // in the caller's pool — nested ranges oversubscribed the cores, and a
    // sequential fully-warm table is also the best-ratio shape per frame
    unsigned nt = n > (4u << 20) ? zn_nthreads() : 1;
    if (nb <= 1) {
        // single block: nothing to link — the 16-bit fast matcher is ~1%
        // tighter than the general one on small inputs
        size_t chunk = n;
        if (chunk) {
            if ((size_t)(oend - op) < 4 + chunk + 16) return (size_t)-1;
            size_t csz = zn_lz4_compress(src, chunk, op + 4, chunk - 1, level);
            if (csz != (size_t)-1 && csz < chunk) {
                op[0] = (uint8_t)csz; op[1] = (uint8_t)(csz >> 8);
                op[2] = (uint8_t)(csz >> 16); op[3] = (uint8_t)(csz >> 24);
                op += 4 + csz;
            } else {
                uint32_t hdr = (uint32_t)chunk | 0x80000000u;
                memcpy(op, &hdr, 4);
                memcpy(op + 4, src, chunk);
                op += 4 + chunk;
            }
        }
        if ((size_t)(oend - op) < 4) return (size_t)-1;
        memset(op, 0, 4);  // EndMark
        op += 4;
        return (size_t)(op - dst);
    }
    {
        // blocks compress into slack-padded scratch (the greedy matcher
        // wildcopies with no per-sequence bounds checks), then concatenate
        // in order; multi-thread runs contiguous block RANGES per thread so
        // each range keeps a warm match table (one cold start per thread).
        const size_t stride = BS + (BS / 255) + 128;
        bool greedy = level <= 2;
        std::unique_ptr<uint8_t[]> scratch(new uint8_t[nb * stride]);
        std::vector<uint32_t> sizes(nb);  // high bit = stored raw
        size_t nranges = (nt >= 2 && nb >= 4) ? nt : 1;
        size_t per = (nb + nranges - 1) / nranges;
        zn_parallel_for(nranges, (unsigned)nranges, [&](size_t r) {
            size_t b0 = r * per;
            size_t b1 = b0 + per < nb ? b0 + per : nb;
            for (size_t i = b0; i < b1; i++) {
                size_t off = i * BS;
                size_t chunk = n - off < BS ? n - off : BS;
                size_t csz = greedy
                    ? lz4_block_linked_greedy(src, off, off + chunk,
                                              scratch.get() + i * stride, i != b0)
                    : lz4_compress_block_linked(src, off, off + chunk,
                                                scratch.get() + i * stride,
                                                stride, level, i != b0);
                sizes[i] = (csz != (size_t)-1 && csz < chunk)
                               ? (uint32_t)csz
                               : ((uint32_t)chunk | 0x80000000u);
            }
        });
        for (size_t i = 0; i < nb; i++) {
            uint32_t hdr = sizes[i];
            size_t payload = hdr & 0x7FFFFFFFu;
            if ((size_t)(oend - op) < 4 + payload + 4) return (size_t)-1;
            memcpy(op, &hdr, 4);
            const uint8_t* from =
                (hdr & 0x80000000u) ? src + i * BS : scratch.get() + i * stride;
            memcpy(op + 4, from, payload);
            op += 4 + payload;
        }
    }
    if ((size_t)(oend - op) < 4) return (size_t)-1;
    memset(op, 0, 4);  // EndMark
    op += 4;
    return (size_t)(op - dst);
}

// Whole-entry compress: n bytes -> consecutive lz4 frames of `chunk` input
// bytes each (linked 64 KiB blocks inside a frame; every frame declares its
// content size -> zero-copy frame-parallel decode), PLUS the XXH3-64 of the
// whole input, in ONE call on one worker pool.  Tasks are (frame, block-
// range) pairs — finer than whole frames, so 2 cores stay busy to the end —
// with the hash as task 0.  Replaces the python writer's slice-per-chunk /
// compress / b"".join / hash sequence (3 extra passes over the corpus).
// `chunk` must be a multiple of 64 KiB.  Returns total bytes or (size_t)-1.
// Role parity: the lz4f side of zpack_compress_file + the XXH3 in
// zpack_add_written_file_entry (lib/zpack_write.c:204-211,256) fused.
// defined in zstd_encode.cpp / zstd_decode.cpp
size_t zn_zstd_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, int level);
size_t zn_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap);

size_t zn_lz4f_compress_chunked(const uint8_t* src, size_t n, size_t chunk,
                                uint8_t* dst, size_t cap, int level,
                                uint64_t* hash_out) {
    const size_t BS = 64 << 10;
    if (hash_out) *hash_out = 0;
    if (chunk == 0 || chunk % BS || chunk >= (1ULL << 30)) return (size_t)-1;
    if (n == 0) {
        if (hash_out) *hash_out = zn_xxh3_64(src, 0);
        return 0;
    }
    size_t nframes = (n + chunk - 1) / chunk;
    size_t bpc = chunk / BS;               // blocks per (full) chunk
    size_t gnb = (n + BS - 1) / BS;        // global block count
    const size_t stride = BS + (BS / 255) + 128;
    std::unique_ptr<uint8_t[]> scratch(new uint8_t[gnb * stride]);
    std::vector<uint32_t> sizes(gnb);      // high bit = stored raw
    unsigned nt = zn_nthreads();
    bool greedy = level <= 2;
    struct Task { size_t foff, b0, b1; };  // block range within one frame
    std::vector<Task> tasks;
    tasks.reserve(nframes * nt + 1);
    for (size_t f = 0; f < nframes; f++) {
        size_t foff = f * chunk;
        size_t flen = n - foff < chunk ? n - foff : chunk;
        size_t nbf = (flen + BS - 1) / BS;
        size_t nr = nt > 1 && nbf >= 16 ? nt : 1;
        size_t per = (nbf + nr - 1) / nr;
        for (size_t r = 0; r < nr; r++) {
            size_t b0 = r * per;
            size_t b1 = b0 + per < nbf ? b0 + per : nbf;
            if (b0 < b1) tasks.push_back({foff, b0, b1});
        }
    }
    size_t ntasks = tasks.size();
    zn_parallel_for(ntasks + 1, nt, [&](size_t t) {
        if (t == 0) {  // hash task first: short, overlaps the first ranges
            uint64_t h = zn_xxh3_64(src, n);
            if (hash_out) *hash_out = h;
            return;
        }
        const Task& tk = tasks[t - 1];
        const uint8_t* base = src + tk.foff;  // positions relative to frame
        size_t flen = n - tk.foff < chunk ? n - tk.foff : chunk;
        for (size_t i = tk.b0; i < tk.b1; i++) {
            size_t off = i * BS;
            size_t blen = flen - off < BS ? flen - off : BS;
            size_t gb = tk.foff / BS + i;
            size_t csz = greedy
                ? lz4_block_linked_greedy(base, off, off + blen,
                                          scratch.get() + gb * stride, i != tk.b0)
                : lz4_compress_block_linked(base, off, off + blen,
                                            scratch.get() + gb * stride,
                                            stride, level, i != tk.b0);
            sizes[gb] = (csz != (size_t)-1 && csz < blen)
                            ? (uint32_t)csz
                            : ((uint32_t)blen | 0x80000000u);
        }
    });
    // assembly: header | blocks | EndMark per frame, in order
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    for (size_t f = 0; f < nframes; f++) {
        size_t foff = f * chunk;
        size_t flen = n - foff < chunk ? n - foff : chunk;
        size_t nbf = (flen + BS - 1) / BS;
        if ((size_t)(oend - op) < 15) return (size_t)-1;
        op[0] = 0x04; op[1] = 0x22; op[2] = 0x4D; op[3] = 0x18;
        op[4] = 0x48; op[5] = 0x40;  // FLG: v01+Linked+ContentSize; BD: 64KB
        uint64_t csz64 = (uint64_t)flen;
        memcpy(op + 6, &csz64, 8);
        op[14] = (uint8_t)(zn_xxh32(op + 4, 10, 0) >> 8);
        op += 15;
        for (size_t i = 0; i < nbf; i++) {
            size_t gb = f * bpc + i;
            uint32_t hdr = sizes[gb];
            size_t payload = hdr & 0x7FFFFFFFu;
            if ((size_t)(oend - op) < 4 + payload + 4) return (size_t)-1;
            memcpy(op, &hdr, 4);
            const uint8_t* from = (hdr & 0x80000000u)
                                      ? src + foff + i * BS
                                      : scratch.get() + gb * stride;
            memcpy(op + 4, from, payload);
            op += 4 + payload;
        }
        memset(op, 0, 4);  // EndMark
        op += 4;
    }
    return (size_t)(op - dst);
}

// Same one-call shape for zstd: one frame per chunk (frame-level tasks; the
// zstd encoder is single-threaded per frame) + the XXH3 of the whole input.
// Segment-parallel zstd is how the multi-MiB archive entries beat the
// single-threaded reference CLI create (role parity: lib/zpack_write.c:179).
size_t zn_zstd_compress_chunked(const uint8_t* src, size_t n, size_t chunk,
                                uint8_t* dst, size_t cap, int level,
                                uint64_t* hash_out) {
    if (hash_out) *hash_out = 0;
    if (chunk == 0) return (size_t)-1;
    if (n == 0) {
        if (hash_out) *hash_out = zn_xxh3_64(src, 0);
        return zn_zstd_compress(src, 0, dst, cap, level);
    }
    size_t nframes = (n + chunk - 1) / chunk;
    size_t bound = chunk + chunk / 128 + 1024;
    std::unique_ptr<uint8_t[]> scratch(new uint8_t[nframes * bound]);
    std::vector<size_t> sizes(nframes);
    std::atomic<bool> bad{false};
    zn_parallel_for(nframes + 1, zn_nthreads(), [&](size_t t) {
        if (t == 0) {
            uint64_t h = zn_xxh3_64(src, n);
            if (hash_out) *hash_out = h;
            return;
        }
        size_t f = t - 1;
        size_t foff = f * chunk;
        size_t flen = n - foff < chunk ? n - foff : chunk;
        size_t r = zn_zstd_compress(src + foff, flen, scratch.get() + f * bound,
                                    bound, level);
        if (r == (size_t)-1) bad.store(true);
        sizes[f] = r;
    });
    if (bad.load()) return (size_t)-1;
    size_t total = 0;
    for (size_t f = 0; f < nframes; f++) total += sizes[f];
    if (total > cap) return (size_t)-1;
    uint8_t* op = dst;
    for (size_t f = 0; f < nframes; f++) {
        memcpy(op, scratch.get() + f * bound, sizes[f]);
        op += sizes[f];
    }
    return total;
}

// One-shot lz4 frame decompress (standard + skippable frames, linked or
// independent blocks, optional checksums). Returns size or (size_t)-1.
size_t zn_lz4f_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    static const size_t BSIZES[8] = {0,0,0,0,64u<<10,256u<<10,1u<<20,4u<<20};
    size_t ip = 0;
    size_t op = 0;
    while (ip < n) {
        if (n - ip < 4) return (size_t)-1;
        uint32_t magic = rd32(src + ip);
        if (magic >= 0x184D2A50u && magic <= 0x184D2A5Fu) {
            if (n - ip < 8) return (size_t)-1;
            uint32_t sz = rd32(src + ip + 4);
            ip += 8 + sz;
            continue;
        }
        if (magic != 0x184D2204u) return (size_t)-1;
        ip += 4;
        if (n - ip < 3) return (size_t)-1;
        uint8_t flg = src[ip], bd = src[ip + 1];
        if ((flg >> 6) != 1) return (size_t)-1;
        bool b_indep = flg & 0x20;  (void)b_indep;  // offsets resolve vs dst history either way
        bool b_chk = flg & 0x10;
        bool c_size = flg & 0x08;
        bool c_chk = flg & 0x04;
        bool dict_id = flg & 0x01;
        size_t desc_len = 2 + (c_size ? 8 : 0) + (dict_id ? 4 : 0);
        if (n - ip < desc_len + 1) return (size_t)-1;
        uint8_t hc = src[ip + desc_len];
        if (((zn_xxh32(src + ip, desc_len, 0) >> 8) & 0xFF) != hc) return (size_t)-1;
        size_t bmax = BSIZES[(bd >> 4) & 7];
        if (!bmax) return (size_t)-1;
        ip += desc_len + 1;
        size_t frame_start = op;
        // Scan the block table up front (sizes are in the headers) so that
        // independent-block frames can decode blocks in parallel.
        struct Blk { size_t off; uint32_t sz; bool raw; };
        std::vector<Blk> blks;
        size_t scan = ip;
        while (true) {
            if (n - scan < 4) return (size_t)-1;
            uint32_t bsz = rd32(src + scan);
            scan += 4;
            if (bsz == 0) break;  // EndMark
            bool uncompressed = bsz & 0x80000000u;
            bsz &= 0x7FFFFFFFu;
            if (bsz > bmax || n - scan < bsz + (b_chk ? 4u : 0u)) return (size_t)-1;
            blks.push_back({scan, bsz, uncompressed});
            scan += bsz + (b_chk ? 4 : 0);
        }
        unsigned nt = zn_nthreads();
        bool done_parallel = false;
        if (b_indep && nt >= 2 && blks.size() >= 4) {
            // Optimistic parallel decode at assumed offsets i*bmax: every
            // non-final block of a full frame produces exactly bmax bytes.
            // Any deviation → redo the frame sequentially (authoritative).
            size_t nb = blks.size();
            std::vector<size_t> produced(nb);
            std::atomic<bool> bad{false};
            zn_parallel_for(nb, nt, [&](size_t i) {
                const Blk& b = blks[i];
                size_t doff = op + i * bmax;
                if (doff > cap) { bad.store(true); return; }
                if (b_chk && zn_xxh32(src + b.off, b.sz, 0) != rd32(src + b.off + b.sz)) {
                    bad.store(true); return;
                }
                // non-final blocks may not write past their bmax-sized slot
                size_t bcap = cap - doff;
                if (i + 1 < nb && bmax < bcap) bcap = bmax;
                size_t out;
                if (b.raw) {
                    out = b.sz;
                    if (bcap < out) { bad.store(true); return; }
                    memcpy(dst + doff, src + b.off, out);
                } else {
                    out = zn_lz4_decompress(src + b.off, b.sz, dst + doff,
                                            bcap, NULL, 0);
                    if (out == (size_t)-1) { bad.store(true); return; }
                }
                produced[i] = out;
                if (i + 1 < nb && out != bmax) bad.store(true);
            });
            if (!bad.load()) {
                op += (nb - 1) * bmax + produced[nb - 1];
                done_parallel = true;
            }
        }
        if (!done_parallel) {
            for (const Blk& b : blks) {
                if (b_chk && zn_xxh32(src + b.off, b.sz, 0) != rd32(src + b.off + b.sz))
                    return (size_t)-1;
                if (b.raw) {
                    if (cap - op < b.sz) return (size_t)-1;
                    memcpy(dst + op, src + b.off, b.sz);
                    op += b.sz;
                } else {
                    size_t out = zn_lz4_decompress(src + b.off, b.sz, dst + op,
                                                   cap - op, dst, op);
                    if (out == (size_t)-1) return (size_t)-1;
                    op += out;
                }
            }
        }
        ip = scan;
        if (c_chk) {
            if (n - ip < 4) return (size_t)-1;
            if (zn_xxh32(dst + frame_start, op - frame_start, 0) != rd32(src + ip)) return (size_t)-1;
            ip += 4;
        }
    }
    return op;
}

// Batch decompress + XXH3-verify N archive entries in one call (parallel
// worker threads; the read-side analog of zn_compress_batch).  Entries may
// sit anywhere in `src` (comp_offs/comp_sizes per entry); outputs go to
// dst at out_offs (n+1 prefix of uncompressed sizes).  Each entry's XXH3
// must equal hashes[i] (reference always verifies: lib/zpack_read.c:466).
// Returns the number of failed entries; fail_mask[i]=1 marks them.
size_t zn_decompress_batch(const uint8_t* src, const uint64_t* comp_offs,
                           const uint64_t* comp_sizes, size_t n,
                           const int32_t* methods, uint8_t* dst,
                           const uint64_t* out_offs, const uint64_t* hashes,
                           uint8_t* fail_mask) {
    std::atomic<size_t> fails{0};
    zn_parallel_for(n, zn_nthreads(), [&](size_t i) {
        const uint8_t* p = src + comp_offs[i];
        size_t clen = (size_t)comp_sizes[i];
        uint8_t* d = dst + out_offs[i];
        size_t want = (size_t)(out_offs[i + 1] - out_offs[i]);
        size_t got;
        switch (methods[i]) {
            case 0:
                got = clen == want ? (memcpy(d, p, clen), clen) : (size_t)-1;
                break;
            case 1: got = zn_zstd_decompress(p, clen, d, want); break;
            case 2: got = zn_lz4f_decompress(p, clen, d, want); break;
            default: got = (size_t)-1;
        }
        bool ok = got == want && zn_xxh3_64(d, want) == hashes[i];
        fail_mask[i] = ok ? 0 : 1;
        if (!ok) fails.fetch_add(1);
    });
    return fails.load();
}

// Batch compress + hash: one call for N archive entries, parallelized over
// worker threads inside the library (no per-entry FFI or GIL traffic —
// the 10k-small-file BASELINE config is bound by per-entry overhead).
// methods: 0=store 1=zstd 2=lz4f.  offs/dst_offs are n+1 prefix arrays.
// out_sizes[i] = compressed size or UINT64_MAX; returns number of failures.
size_t zn_compress_batch(const uint8_t* src, const uint64_t* offs, size_t n,
                         const int32_t* methods, const int32_t* levels,
                         uint8_t* dst, const uint64_t* dst_offs,
                         uint64_t* out_sizes, uint64_t* out_hashes) {
    std::atomic<size_t> fails{0};
    zn_parallel_for(n, zn_nthreads(), [&](size_t i) {
        const uint8_t* p = src + offs[i];
        size_t len = (size_t)(offs[i + 1] - offs[i]);
        uint8_t* d = dst + dst_offs[i];
        size_t cap = (size_t)(dst_offs[i + 1] - dst_offs[i]);
        out_hashes[i] = zn_xxh3_64(p, len);
        size_t r;
        switch (methods[i]) {
            case 0:
                if (len <= cap) { memcpy(d, p, len); r = len; }
                else r = (size_t)-1;
                break;
            case 1: r = zn_zstd_compress(p, len, d, cap, levels[i]); break;
            case 2: r = zn_lz4f_compress(p, len, d, cap, levels[i]); break;
            default: r = (size_t)-1;
        }
        if (r == (size_t)-1) fails.fetch_add(1);
        out_sizes[i] = (uint64_t)r;
    });
    return fails.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// XXH3-64 streaming state (bit-compatible with XXH3_64bits_reset/update/
// digest; mirrors zpack_tpu/codecs/xxh3.py XXH3State)
// ---------------------------------------------------------------------------

extern "C" {

struct ZnXxh3State {
    uint64_t acc[8];
    uint8_t buf[320];
    size_t buflen;
    uint8_t last64[64];
    size_t last_len;
    uint64_t total;
    int stripe_in_block;
    uint8_t small_buf[241];
    int small_mode;  // 1 while total <= 240 (retain everything)
};

static void zn_xxh3_reset_state(ZnXxh3State* s) {
    static const uint64_t init[8] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
    memcpy(s->acc, init, sizeof(init));
    s->buflen = 0;
    s->last_len = 0;
    s->total = 0;
    s->stripe_in_block = 0;
    s->small_mode = 1;
}

void* zn_xxh3_new(void) {
    ZnXxh3State* s = new ZnXxh3State();
    zn_xxh3_reset_state(s);
    return s;
}

void zn_xxh3_free(void* p) { delete (ZnXxh3State*)p; }

static void zn_xxh3_consume(ZnXxh3State* s, const uint8_t* d, size_t n) {
    // accumulate whole stripes, keeping >= 1 byte buffered
    // (stripe k only processed once a byte beyond its end has been seen)
    // rolling last-64
    if (n >= 64) {
        memcpy(s->last64, d + n - 64, 64);
        s->last_len = 64;
    } else {
        size_t keep = 64 - n < s->last_len ? 64 - n : s->last_len;
        memmove(s->last64, s->last64 + s->last_len - keep, keep);
        memcpy(s->last64 + keep, d, n);
        s->last_len = keep + n;
    }
    size_t pos = 0;
    while (s->buflen + (n - pos) >= 65) {
        // fill buffer to one stripe
        size_t need = 64 - s->buflen;
        if (n - pos < need + 1) {
            // can't complete a stripe while leaving 1 byte: buffer the rest
            break;
        }
        memcpy(s->buf + s->buflen, d + pos, need);
        pos += need;
        accum512(s->acc, s->buf, kSecret + 8 * s->stripe_in_block);
        s->buflen = 0;
        s->stripe_in_block++;
        if (s->stripe_in_block == 16) {
            for (int i = 0; i < 8; i++) {
                uint64_t a = s->acc[i];
                a ^= a >> 47;
                a ^= rd64(kSecret + 192 - 64 + 8 * i);
                s->acc[i] = a * P32_1;
            }
            s->stripe_in_block = 0;
        }
    }
    memcpy(s->buf + s->buflen, d + pos, n - pos);
    s->buflen += n - pos;
}

void zn_xxh3_update(void* p, const uint8_t* d, size_t n) {
    ZnXxh3State* s = (ZnXxh3State*)p;
    if (!n) return;
    if (s->small_mode) {
        if (s->total + n <= 240) {
            memcpy(s->small_buf + s->total, d, n);
            s->total += n;
            return;
        }
        // spill: feed the retained prefix through the long path
        s->small_mode = 0;
        uint64_t retained = s->total;
        s->total += n;
        zn_xxh3_consume(s, s->small_buf, (size_t)retained);
        zn_xxh3_consume(s, d, n);
        return;
    }
    s->total += n;
    zn_xxh3_consume(s, d, n);
}

uint64_t zn_xxh3_digest(void* p) {
    ZnXxh3State* s = (ZnXxh3State*)p;
    if (s->small_mode) return zn_xxh3_64(s->small_buf, (size_t)s->total);
    uint64_t acc[8];
    memcpy(acc, s->acc, sizeof(acc));
    // no whole stripes remain (buflen <= 64); final overlapping stripe
    accum512(acc, s->last64, kSecret + 192 - 64 - 7);
    uint64_t result = s->total * P64_1;
    for (int i = 0; i < 4; i++)
        result += mul128_fold64(acc[2 * i] ^ rd64(kSecret + 11 + 16 * i),
                                acc[2 * i + 1] ^ rd64(kSecret + 11 + 16 * i + 8));
    return avalanche3(result);
}

}  // extern "C"

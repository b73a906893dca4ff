// Host-side bulk kernels of the load path, for nine GGUF block formats
// (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K, Q6_K, Q8_K):
//
//   dequant_<fmt>(in, out, nblocks): raw blocks -> f32 values, bit-equal to
//       quant/dequant.py's numpy functions (the same products in the same
//       order; built with -ffp-contract=off, so no FMA contraction);
//   extract_<fmt>(in, q, scales, mins, nblocks): raw blocks -> the integer
//       levels (one byte per element), the per-group effective scales and
//       mins that quant/repack._extract returns, bit-equal to its numpy
//       version;
//   transpose_u8(in, out, n, m): the repack's [N, M] -> [M, N] byte copy;
//   f16_to_f32_buf / bf16_to_f32_buf: plain float buffers.
//
// Built on first use by native/__init__.py with
//   g++ -O3 -march=native -fopenmp -ffp-contract=off -shared -fPIC
// and called through ctypes, which releases the GIL for the call.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal: man * 2^-24, normalised to bit 10
            int shift = 0;
            while (!(man & 0x400)) { man <<= 1; ++shift; }
            man &= 0x3FF;
            bits = sign | ((uint32_t)(113 - shift) << 23) | (man << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

inline uint16_t load_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

inline uint32_t load_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// llama.cpp get_scale_min_k4: 12 packed bytes -> 8 six-bit scales and mins
inline void k4_scale_min(const uint8_t* s, float* sc, float* mn) {
    for (int j = 0; j < 4; ++j) {
        sc[j] = (float)(s[j] & 63);
        mn[j] = (float)(s[j + 4] & 63);
        sc[j + 4] = (float)((s[j + 8] & 0x0F) | ((s[j] >> 6) << 4));
        mn[j + 4] = (float)((s[j + 8] >> 4) | ((s[j + 4] >> 6) << 4));
    }
}

// Q4_K / Q5_K element e of a super-block: its byte in qs and its nibble
inline int k4_byte(int e) { return (e / 64) * 32 + e % 32; }
inline int k4_shift(int e) { return ((e % 64) / 32) * 4; }

// Q6_K element e: its low bits in ql, high bits in qh and its scale index
inline int q6_level(const uint8_t* ql, const uint8_t* qh, int e) {
    int n = e / 128, quarter = (e % 128) / 32, l = e % 32;
    int lo = (ql[n * 64 + l + ((quarter % 2) ? 32 : 0)] >>
              ((quarter >= 2) ? 4 : 0)) & 0x0F;
    int hi = (qh[n * 32 + l] >> (2 * quarter)) & 0x03;
    return (lo | (hi << 4)) - 32;
}

inline int q6_scale_index(int e) {
    int n = e / 128, quarter = (e % 128) / 32, l = e % 32;
    return n * 8 + l / 16 + 2 * quarter;
}

// the 5-bit level of Q5_0 / Q5_1 element j (0..31) of a block
inline int q5_level(const uint8_t* qs, uint32_t qh, int j) {
    return j < 16 ? (qs[j] & 0x0F) | (((qh >> j) & 1) << 4)
                  : (qs[j - 16] >> 4) | (((qh >> j) & 1) << 4);
}

}  // namespace

extern "C" {

// ---- dequant: legacy 32-element blocks ---------------------------------------

void dequant_q4_0(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 18;
        float* o = out + b * 32;
        float d = f16_to_f32(load_u16(p));
        const uint8_t* qs = p + 2;
        for (int j = 0; j < 16; ++j) {
            o[j] = (float)((int)(qs[j] & 0x0F) - 8) * d;
            o[j + 16] = (float)((int)(qs[j] >> 4) - 8) * d;
        }
    }
}

void dequant_q4_1(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 20;
        float* o = out + b * 32;
        float d = f16_to_f32(load_u16(p));
        float m = f16_to_f32(load_u16(p + 2));
        const uint8_t* qs = p + 4;
        for (int j = 0; j < 16; ++j) {
            o[j] = (float)(qs[j] & 0x0F) * d + m;
            o[j + 16] = (float)(qs[j] >> 4) * d + m;
        }
    }
}

void dequant_q5_0(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 22;
        float* o = out + b * 32;
        float d = f16_to_f32(load_u16(p));
        uint32_t qh = load_u32(p + 2);
        for (int j = 0; j < 32; ++j)
            o[j] = (float)(q5_level(p + 6, qh, j) - 16) * d;
    }
}

void dequant_q5_1(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 24;
        float* o = out + b * 32;
        float d = f16_to_f32(load_u16(p));
        float m = f16_to_f32(load_u16(p + 2));
        uint32_t qh = load_u32(p + 4);
        for (int j = 0; j < 32; ++j)
            o[j] = (float)q5_level(p + 8, qh, j) * d + m;
    }
}

void dequant_q8_0(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 34;
        float* o = out + b * 32;
        float d = f16_to_f32(load_u16(p));
        const int8_t* qs = (const int8_t*)(p + 2);
        for (int j = 0; j < 32; ++j) o[j] = (float)qs[j] * d;
    }
}

// ---- dequant: K-quants (256-element super-blocks) ----------------------------

void dequant_q4_k(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 144;
        float* o = out + b * 256;
        float d = f16_to_f32(load_u16(p));
        float dmin = f16_to_f32(load_u16(p + 2));
        float sc[8], mn[8];
        k4_scale_min(p + 4, sc, mn);
        const uint8_t* qs = p + 16;
        for (int e = 0; e < 256; ++e) {
            int g = e / 32;
            float q = (float)((qs[k4_byte(e)] >> k4_shift(e)) & 0x0F);
            o[e] = (d * sc[g]) * q - dmin * mn[g];
        }
    }
}

void dequant_q5_k(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 176;
        float* o = out + b * 256;
        float d = f16_to_f32(load_u16(p));
        float dmin = f16_to_f32(load_u16(p + 2));
        float sc[8], mn[8];
        k4_scale_min(p + 4, sc, mn);
        const uint8_t* qh = p + 16;
        const uint8_t* qs = p + 48;
        for (int e = 0; e < 256; ++e) {
            int g = e / 32;
            int hbit = (qh[e % 32] >> (e / 32)) & 1;
            float q = (float)((qs[k4_byte(e)] >> k4_shift(e)) & 0x0F) +
                      16.0f * (float)hbit;
            o[e] = (d * sc[g]) * q - dmin * mn[g];
        }
    }
}

void dequant_q6_k(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 210;
        const int8_t* scales = (const int8_t*)(p + 192);
        float d = f16_to_f32(load_u16(p + 208));
        float* o = out + b * 256;
        for (int e = 0; e < 256; ++e)
            o[e] = d * (float)scales[q6_scale_index(e)] *
                   (float)q6_level(p, p + 128, e);
    }
}

void dequant_q8_k(const uint8_t* in, float* out, int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 292;
        float d;
        std::memcpy(&d, p, 4);
        const int8_t* qs = (const int8_t*)(p + 4);
        float* o = out + b * 256;
        for (int j = 0; j < 256; ++j) o[j] = (float)qs[j] * d;
    }
}

// ---- extract: levels, scales and mins of the kernel layouts ------------------
// q: one byte per element (uint8 levels 0..15 for the q4 layout's formats,
// int8 for the q8 layout's); scales and mins: one f32 per group, in block
// order (groups of 32, or 16 for Q6_K, 256 for Q8_K); mins is not written
// by the formats without one (Q5_0, Q8_0, Q6_K, Q8_K).

void extract_q4_0(const uint8_t* in, uint8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 18;
        uint8_t* o = q + b * 32;
        float d = f16_to_f32(load_u16(p));
        for (int j = 0; j < 16; ++j) {
            o[j] = p[2 + j] & 0x0F;
            o[j + 16] = p[2 + j] >> 4;
        }
        scales[b] = d;
        mins[b] = 8.0f * d;
    }
}

void extract_q4_1(const uint8_t* in, uint8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 20;
        uint8_t* o = q + b * 32;
        for (int j = 0; j < 16; ++j) {
            o[j] = p[4 + j] & 0x0F;
            o[j + 16] = p[4 + j] >> 4;
        }
        scales[b] = f16_to_f32(load_u16(p));
        mins[b] = -f16_to_f32(load_u16(p + 2));
    }
}

void extract_q5_0(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
    (void)mins;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 22;
        int8_t* o = q + b * 32;
        uint32_t qh = load_u32(p + 2);
        for (int j = 0; j < 32; ++j)
            o[j] = (int8_t)(q5_level(p + 6, qh, j) - 16);
        scales[b] = f16_to_f32(load_u16(p));
    }
}

void extract_q5_1(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 24;
        int8_t* o = q + b * 32;
        uint32_t qh = load_u32(p + 4);
        for (int j = 0; j < 32; ++j) o[j] = (int8_t)q5_level(p + 8, qh, j);
        scales[b] = f16_to_f32(load_u16(p));
        mins[b] = -f16_to_f32(load_u16(p + 2));
    }
}

void extract_q8_0(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
    (void)mins;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 34;
        std::memcpy(q + b * 32, p + 2, 32);
        scales[b] = f16_to_f32(load_u16(p));
    }
}

void extract_q4_k(const uint8_t* in, uint8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 144;
        uint8_t* o = q + b * 256;
        float d = f16_to_f32(load_u16(p));
        float dmin = f16_to_f32(load_u16(p + 2));
        float sc[8], mn[8];
        k4_scale_min(p + 4, sc, mn);
        for (int e = 0; e < 256; ++e)
            o[e] = (p[16 + k4_byte(e)] >> k4_shift(e)) & 0x0F;
        for (int g = 0; g < 8; ++g) {
            scales[b * 8 + g] = d * sc[g];
            mins[b * 8 + g] = dmin * mn[g];
        }
    }
}

void extract_q5_k(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 176;
        int8_t* o = q + b * 256;
        float d = f16_to_f32(load_u16(p));
        float dmin = f16_to_f32(load_u16(p + 2));
        float sc[8], mn[8];
        k4_scale_min(p + 4, sc, mn);
        const uint8_t* qh = p + 16;
        const uint8_t* qs = p + 48;
        for (int e = 0; e < 256; ++e) {
            int hbit = (qh[e % 32] >> (e / 32)) & 1;
            o[e] = (int8_t)(((qs[k4_byte(e)] >> k4_shift(e)) & 0x0F) +
                            16 * hbit);
        }
        for (int g = 0; g < 8; ++g) {
            scales[b * 8 + g] = d * sc[g];
            mins[b * 8 + g] = dmin * mn[g];
        }
    }
}

void extract_q6_k(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
    (void)mins;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 210;
        int8_t* o = q + b * 256;
        const int8_t* sc = (const int8_t*)(p + 192);
        float d = f16_to_f32(load_u16(p + 208));
        for (int e = 0; e < 256; ++e) o[e] = (int8_t)q6_level(p, p + 128, e);
        // each natural group of 16 elements shares one stored scale
        for (int g = 0; g < 16; ++g)
            scales[b * 16 + g] = d * (float)sc[q6_scale_index(16 * g)];
    }
}

void extract_q8_k(const uint8_t* in, int8_t* q, float* scales, float* mins,
                  int64_t nblocks) {
    (void)mins;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* p = in + b * 292;
        std::memcpy(&scales[b], p, 4);
        std::memcpy(q + b * 256, p + 4, 256);
    }
}

// ---- transpose: the repack's [N, M] -> [M, N] copy of one-byte levels -----------

void transpose_u8(const uint8_t* in, uint8_t* out, int64_t n, int64_t m) {
    // 64 x 64 tiles; each thread writes whole rows of out
#pragma omp parallel for schedule(static)
    for (int64_t j0 = 0; j0 < m; j0 += 64) {
        int64_t j1 = j0 + 64 < m ? j0 + 64 : m;
        for (int64_t i0 = 0; i0 < n; i0 += 64) {
            int64_t i1 = i0 + 64 < n ? i0 + 64 : n;
            for (int64_t j = j0; j < j1; ++j)
                for (int64_t i = i0; i < i1; ++i) out[j * n + i] = in[i * m + j];
        }
    }
}

// ---- f16/bf16 bulk conversion ------------------------------------------------

void f16_to_f32_buf(const uint8_t* in, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        out[i] = f16_to_f32(load_u16(in + 2 * i));
}

void bf16_to_f32_buf(const uint8_t* in, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits = (uint32_t)load_u16(in + 2 * i) << 16;
        std::memcpy(&out[i], &bits, 4);
    }
}

int native_num_threads(void) {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"

// Dequant-dot body of the CUDA-core MoE kernels (csrc/moe_qmatmul.cu): the
// grouped kernels 5 and 6 for the layouts their tensor-core path
// (csrc/qgemm.cu) does not take.
//
// Layouts (quant/repack.py):
//   q4: packed uint8 [K/2, ldw]; packed row r belongs to scale group
//       g = r / (group/2) and holds element j = r % (group/2) of that group in
//       its low nibble and element j + group/2 in its high nibble.
//   q8: int8 [K, ldw].
//   scales, mins: float32 or bfloat16 [K/group, ldw] (the panel type SP);
//       W[k, n] = s[g, n] * q[k, n] - m[g, n].
//
// A block of TX x TY = 256 threads owns a tile of COLS = 32 output columns and
// RB <= 8 rows and loops over all of K itself; nothing carries across blocks.
// TX = 8 threads along N each take 4 adjacent columns (one 32-bit load
// fetches 4 columns' bytes, so a warp reads whole 32-byte sectors); TY = 32
// threads along K take the scale groups round-robin. Nibbles are unpacked in
// registers straight from the group-split bytes. The min term is factored per
// group as s * sum(x * q) - m * sum(x) (the TPU kernels' _min_dot). The 32
// K-partials are summed through shared memory, in a fixed order. All sums are
// float32 whatever the panel type; a bfloat16 output is rounded once, at the
// store (the TPU kernels' acc.astype(o_ref.dtype)).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "glu.cuh"

namespace qdot {

constexpr int TX = 8;
constexpr int TY = 32;
constexpr int COLS = 4 * TX;
constexpr int THREADS = TX * TY;

enum { FMT_Q4 = 0, FMT_Q8 = 1 };

using bf16 = __nv_bfloat16;

// One weight set as this thread sees it: each pointer already at the
// thread's first column (and, for an expert stack, at the expert's slice).
// SP: the scale/min panel type, float or bf16.
template <class SP>
struct Panel {
    const uint8_t* packed;
    const SP* scales;
    const SP* mins;  // null: no min term
};

// Four consecutive bytes (columns n0..n0+3) as one word; missing columns read 0.
__device__ __forceinline__ uint32_t load_bytes4(const uint8_t* p, int nvalid, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
        if (c < nvalid) w |= uint32_t(__ldg(p + c)) << (8 * c);
    return w;
}

__device__ __forceinline__ void load_f4(const float* p, int nvalid, bool vec, float out[4]) {
    if (vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
        return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = c < nvalid ? __ldg(p + c) : 0.0f;
}

// Four bf16 panel values as float: one 8-byte load when vec (a panel row of
// N % 4 == 0 bf16 values keeps every 4-column group 8-byte aligned).
__device__ __forceinline__ void load_f4(const bf16* p, int nvalid, bool vec, float out[4]) {
    if (vec) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
        out[0] = __low2float(lo); out[1] = __high2float(lo);
        out[2] = __low2float(hi); out[3] = __high2float(hi);
        return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = c < nvalid ? __bfloat162float(__ldg(p + c)) : 0.0f;
}

// The output store: float as it is, bf16 rounded to nearest even.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

using glu::glu_combine;

// total[s] = sum_k x_r[k] * W_s[k, c] for the NW weight sets of this block's
// tile, where thread tid = ty * TX + tx < RB * COLS owns row r = tid / COLS
// and tile column c = tid % COLS (other threads get 0). Every thread of the
// block must call it (it synchronises). xr: the RB input rows; nvalid: the
// columns left from this thread's first column (<= 0: none); ldw: the
// panels' row stride in columns; group % 16 == 0. VEC (4-column vector
// loads: N % 4 == 0 and each panel aligned to 4 of its elements) is a
// template parameter so that the inner loops carry no branch on it. Row
// addresses: one set keeps a pointer per group, two sets share one offset,
// the form ptxas schedules better for each.
template <int FMT, int RB, int NW, bool VEC, class SP>
__device__ __forceinline__ void dot_tile(const float* const (&xr)[RB], const Panel<SP> (&w)[NW],
                                         int K, int ldw, int group, int nvalid,
                                         float (&total)[NW]) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const bool has_mins = w[0].mins != nullptr;  // all sets alike
    float acc[NW][RB][4] = {};

    if (nvalid > 0) {
        const int ngroups = K / group;
        for (int g = ty; g < ngroups; g += TY) {
            float qd[NW][RB][4] = {};
            float xs[RB] = {};
            const int k0 = g * group;
            if (FMT == FMT_Q4) {
                const int h = group >> 1;
                const size_t grow = size_t(g) * h * ldw, off = NW == 1 ? 0 : grow;
                const uint8_t* prow[NW];
#pragma unroll
                for (int s = 0; s < NW; ++s) prow[s] = w[s].packed + (grow - off);
                for (int j = 0; j < h; ++j) {
                    uint32_t wv[NW];
#pragma unroll
                    for (int s = 0; s < NW; ++s)
                        wv[s] = load_bytes4(prow[s] + off + size_t(j) * ldw, nvalid, VEC);
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        const float xlo = __ldg(xr[r] + k0 + j);
                        const float xhi = __ldg(xr[r] + k0 + j + h);
                        xs[r] += xlo + xhi;
#pragma unroll
                        for (int s = 0; s < NW; ++s)
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const float lo = float((wv[s] >> (8 * c)) & 0xFu);
                                const float hi = float((wv[s] >> (8 * c + 4)) & 0xFu);
                                qd[s][r][c] = fmaf(xlo, lo, qd[s][r][c]);
                                qd[s][r][c] = fmaf(xhi, hi, qd[s][r][c]);
                            }
                    }
                }
            } else {
                const size_t grow = size_t(k0) * ldw, off = NW == 1 ? 0 : grow;
                const uint8_t* prow[NW];
#pragma unroll
                for (int s = 0; s < NW; ++s) prow[s] = w[s].packed + (grow - off);
                for (int j = 0; j < group; ++j) {
                    uint32_t wv[NW];
#pragma unroll
                    for (int s = 0; s < NW; ++s)
                        wv[s] = load_bytes4(prow[s] + off + size_t(j) * ldw, nvalid, VEC);
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        const float xv = __ldg(xr[r] + k0 + j);
                        xs[r] += xv;
#pragma unroll
                        for (int s = 0; s < NW; ++s)
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const float q = float(int8_t((wv[s] >> (8 * c)) & 0xFFu));
                                qd[s][r][c] = fmaf(xv, q, qd[s][r][c]);
                            }
                    }
                }
            }
#pragma unroll
            for (int s = 0; s < NW; ++s) {
                float sc[4], mn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                load_f4(w[s].scales + size_t(g) * ldw, nvalid, VEC, sc);
                if (has_mins) load_f4(w[s].mins + size_t(g) * ldw, nvalid, VEC, mn);
#pragma unroll
                for (int r = 0; r < RB; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[s][r][c] = fmaf(sc[c], qd[s][r][c], acc[s][r][c]) - mn[c] * xs[r];
            }
        }
    }

    // Sum the TY partials of every (row, column) through shared memory, one
    // weight set at a time.
    __shared__ float red[TY][RB][COLS];
    const int tid = ty * TX + tx;
#pragma unroll
    for (int s = 0; s < NW; ++s) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) red[ty][r][4 * tx + c] = acc[s][r][c];
        __syncthreads();
        total[s] = 0.0f;
        if (tid < RB * COLS) {
            const int r = tid / COLS, c = tid % COLS;
            float t = 0.0f;
#pragma unroll 8
            for (int k = 0; k < TY; ++k) t += red[k][r][c];
            total[s] = t;
        }
        __syncthreads();
    }
}

}  // namespace qdot

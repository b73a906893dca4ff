// Dequant-matmul variants for Hopper (sm_90a): the decode-shape probe of the
// q4/q8 kernels, each variant changing one piece of the dequant chain, so that
// their times on this card say where a decode GEMV's time goes.
//
// Replaces the Pallas kernels built by the pallas() helper of
// scripts/bench_kernel_variants.py:124-131, with the bodies
//   v2_noscale  :282-289  y = x @ q                      (variant_f32, q8)
//   v5_minfold  :159-188  y = x @ (s*q) - xg^T @ m       (variant_f32)
//   v6_bf16     :190-218  v5 with w = bf16(q*s), x and xg rounded to bf16
//                                                        (variant_bf16)
//   v7_int8     :220-247  y = xi @ q, int8 x             (variant_int8)
//   v9_mulcost  :397-410  y = xi @ wrap8(q*u)            (variant_int8, q4)
//   v10_4dot    :412-427  y = sum (x_lo+x_hi)(lo+hi)     (variant_int8, q4)
//   v8_w4a8     :311-387  y = S * [sum_g u * (xi @ q)_g - xg2^T @ m2]
//                                                        (variant_w4a8, q4)
// v0_full and v1_nomin of the probe are the production kernels 1-2 of
// csrc/qgemm.cu with bf16 panels in "default" precision, not kernels here.
//
// Layouts as csrc/qdot.cuh: q4 packed uint8 [K/2, N] group-split (packed row
// r of group g holds element j = r % (group/2) in its low nibble and element
// j + group/2 in its high nibble), q8 int8 [K, N]; panels bfloat16
// [K/group, N]; u int8 [K/group, N]; xg, xg2 float32 [K/group, B] (per-group
// sums of x, computed outside the kernel as in the probe); S float32 [N].
// Each nibble meets its own element of x (the TPU bodies met an arranged x in
// v5, v6 and v8 and an unarranged one in v7, v9 and v10).
//
// What bounds them on this card: these are decode GEMVs (B = 8 rows), so the
// bytes read once from HBM: at K x N = 4096 x 14336 the q4 packed data plus
// its bf16 scale and min panels are 36.70 MB (11.0 us at 3.35 TB/s), q8
// 66.06 MB (19.7 us); each variant reads a subset or a substitute of these.
// Design: the block layout of qdot.cuh (32 output columns x 8 rows over all of
// K; 8 threads along N load 4 columns' bytes as one word, 32 threads along K
// take the scale groups round-robin, partials meet once in shared memory in a
// fixed order). The f32 and bf16 variants dequantize in registers on the CUDA
// cores. The int8 variants transpose four packed rows' words with byte
// permutes so that each word holds four K-consecutive bytes of one column,
// and feed them to __dp4a (four int8 products into an i32 accumulator): no
// float dequant at all. The i32 partials are summed exactly, so v7, v9 and
// v10 are integers converted to float once. v8 multiplies each group's i32
// dot by its int8 scale code and adds it to a float accumulator once per
// group (an i32 accumulator over K = 14336 could overflow: 127 * 15 * 127 *
// 14336 > 2^31).

#include "qdot.cuh"

namespace {

using namespace qdot;

constexpr int RB = 8;  // rows per block: the probe's B

enum { V_NOSCALE = 0, V_MINFOLD = 1, V_BF16 = 2 };     // variant_f32 / variant_bf16
enum { V_INT8 = 0, V_MULCOST = 1, V_4DOT = 2 };        // variant_int8

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum the TY partials of every (row, column) of the tile through shared
// memory, in a fixed order. Thread tid < RB * COLS gets the total of row
// tid / COLS, tile column tid % COLS; every thread must call it.
template <class T>
__device__ __forceinline__ T tile_total(const T (&acc)[RB][4]) {
    __shared__ T red[TY][RB][COLS];
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[ty][r][4 * tx + c] = acc[r][c];
    __syncthreads();
    T t = 0;
    if (tid < RB * COLS) {
        const int r = tid / COLS, c = tid % COLS;
#pragma unroll 8
        for (int k = 0; k < TY; ++k) t += red[k][r][c];
    }
    return t;
}

// Four packed rows' words (4 columns each) -> four words of 4 K-consecutive
// bytes, one per column: t[c] byte i = byte c of w[i].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
    const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
    t[0] = __byte_perm(a, b, 0x5410);
    t[1] = __byte_perm(a, b, 0x7632);
    t[2] = __byte_perm(c, d, 0x5410);
    t[3] = __byte_perm(c, d, 0x7632);
}

// Each byte of v (a nibble, 0..15) times uu (the int8 code read as 0..255),
// kept modulo 256: the int8 wrap of the product (v9). Two 16-bit lanes per
// multiply, so no carry crosses a byte.
__device__ __forceinline__ uint32_t mul_wrap8(uint32_t v, uint32_t uu) {
    const uint32_t even = ((v & 0x00FF00FFu) * uu) & 0x00FF00FFu;
    const uint32_t odd = (((v >> 8) & 0x00FF00FFu) * uu) & 0x00FF00FFu;
    return even | (odd << 8);
}

// v2 / v5 (f32) and v6 (bf16 dequant) over one 32-column x 8-row tile.
template <int FMT, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
variant_float_kernel(const float* __restrict__ x,       // [B, K]
                     const float* __restrict__ xg,      // [K/group, B] or null
                     const uint8_t* __restrict__ packed,
                     const bf16* __restrict__ scales,   // [K/group, N] or null (v2)
                     const bf16* __restrict__ mins,     // [K/group, N] or null
                     float* __restrict__ y,             // [B, N]
                     int B, int K, int N, int group) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int n0 = blockIdx.x * COLS + 4 * tx;
    const int row0 = blockIdx.y * RB;
    const int nvalid = N - n0;
    int rows[RB];
    const float* xr[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        rows[r] = min(row0 + r, B - 1);
        xr[r] = x + size_t(rows[r]) * K;
    }
    float acc[RB][4] = {};
    if (nvalid > 0) {
        for (int g = ty; g < K / group; g += TY) {
            float sc[4] = {1.0f, 1.0f, 1.0f, 1.0f}, mn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (MODE != V_NOSCALE) {
                load_f4(scales + size_t(g) * N + n0, nvalid, VEC, sc);
                if (mins != nullptr) load_f4(mins + size_t(g) * N + n0, nvalid, VEC, mn);
            }
            float qd[RB][4] = {};
            const int k0 = g * group;
            if (FMT == FMT_Q4) {
                const int h = group >> 1;
                for (int j = 0; j < h; ++j) {
                    const uint32_t wv = load_bytes4(packed + (size_t(g) * h + j) * N + n0, nvalid, VEC);
                    float lo[4], hi[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        lo[c] = float((wv >> (8 * c)) & 0xFu);
                        hi[c] = float((wv >> (8 * c + 4)) & 0xFu);
                        if (MODE == V_BF16) {
                            lo[c] = round_bf16(lo[c] * sc[c]);
                            hi[c] = round_bf16(hi[c] * sc[c]);
                        }
                    }
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        float xlo = __ldg(xr[r] + k0 + j), xhi = __ldg(xr[r] + k0 + j + h);
                        if (MODE == V_BF16) { xlo = round_bf16(xlo); xhi = round_bf16(xhi); }
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            qd[r][c] = fmaf(xlo, lo[c], qd[r][c]);
                            qd[r][c] = fmaf(xhi, hi[c], qd[r][c]);
                        }
                    }
                }
            } else {
                for (int j = 0; j < group; ++j) {
                    const uint32_t wv = load_bytes4(packed + size_t(k0 + j) * N + n0, nvalid, VEC);
                    float q[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        q[c] = float(int8_t((wv >> (8 * c)) & 0xFFu));
                        if (MODE == V_BF16) q[c] = round_bf16(q[c] * sc[c]);
                    }
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        float xv = __ldg(xr[r] + k0 + j);
                        if (MODE == V_BF16) xv = round_bf16(xv);
#pragma unroll
                        for (int c = 0; c < 4; ++c) qd[r][c] = fmaf(xv, q[c], qd[r][c]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                float xs = 0.0f;
                if (MODE != V_NOSCALE && mins != nullptr) {
                    xs = __ldg(xg + size_t(g) * B + rows[r]);
                    if (MODE == V_BF16) xs = round_bf16(xs);
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if (MODE == V_MINFOLD) acc[r][c] = fmaf(sc[c], qd[r][c], acc[r][c]) - mn[c] * xs;
                    else if (MODE == V_BF16) acc[r][c] += qd[r][c] - xs * mn[c];
                    else acc[r][c] += qd[r][c];
                }
            }
        }
    }
    const float total = tile_total(acc);
    const int tid = ty * TX + tx;
    if (tid < RB * COLS) {
        const int row = row0 + tid / COLS, col = blockIdx.x * COLS + tid % COLS;
        if (row < B && col < N) y[size_t(row) * N + col] = total;
    }
}

// The i32 dot of one scale group for this thread's 4 columns and RB rows:
// d[r][c] += sum_{k in g} xi[r, k] * q[k, n0 + c] (q4: the nibbles; q8: the
// int8 values), with the MODE's change (v9: q * u wrapped to int8; v10: each
// byte meets both of its x elements twice).
template <int FMT, int MODE, bool VEC>
__device__ __forceinline__ void group_dot(const int8_t* const (&xr)[RB], const uint8_t* packed,
                                          const int8_t* u, int g, int N, int n0, int nvalid,
                                          int group, int (&d)[RB][4]) {
    const int k0 = g * group;
    uint32_t uu[4] = {0, 0, 0, 0};
    if (MODE == V_MULCOST) {
        const uint32_t uw = load_bytes4(reinterpret_cast<const uint8_t*>(u) + size_t(g) * N + n0,
                                        nvalid, VEC);
#pragma unroll
        for (int c = 0; c < 4; ++c) uu[c] = (uw >> (8 * c)) & 0xFFu;
    }
    if (FMT == FMT_Q4) {
        const int h = group >> 1;
        for (int j0 = 0; j0 < h; j0 += 4) {
            uint32_t w[4], t[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                w[i] = load_bytes4(packed + (size_t(g) * h + j0 + i) * N + n0, nvalid, VEC);
            transpose4(w, t);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                const int xlo = __ldg(reinterpret_cast<const int*>(xr[r] + k0 + j0));
                const int xhi = __ldg(reinterpret_cast<const int*>(xr[r] + k0 + h + j0));
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    uint32_t lo = t[c] & 0x0F0F0F0Fu, hi = (t[c] >> 4) & 0x0F0F0F0Fu;
                    if (MODE == V_MULCOST) { lo = mul_wrap8(lo, uu[c]); hi = mul_wrap8(hi, uu[c]); }
                    d[r][c] = __dp4a(xlo, int(lo), d[r][c]);
                    d[r][c] = __dp4a(xhi, int(hi), d[r][c]);
                    if (MODE == V_4DOT) {
                        d[r][c] = __dp4a(xlo, int(hi), d[r][c]);
                        d[r][c] = __dp4a(xhi, int(lo), d[r][c]);
                    }
                }
            }
        }
    } else {
        for (int j0 = 0; j0 < group; j0 += 4) {
            uint32_t w[4], t[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                w[i] = load_bytes4(packed + size_t(k0 + j0 + i) * N + n0, nvalid, VEC);
            transpose4(w, t);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                const int xv = __ldg(reinterpret_cast<const int*>(xr[r] + k0 + j0));
#pragma unroll
                for (int c = 0; c < 4; ++c) d[r][c] = __dp4a(xv, int(t[c]), d[r][c]);
            }
        }
    }
}

// v7, v9, v10: y = the i32 dot over all of K, converted to float once.
template <int FMT, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
variant_int8_kernel(const int8_t* __restrict__ xi,      // [B, K]
                    const uint8_t* __restrict__ packed,
                    const int8_t* __restrict__ u,       // [K/group, N] (v9) or null
                    float* __restrict__ y,              // [B, N]
                    int B, int K, int N, int group) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int n0 = blockIdx.x * COLS + 4 * tx;
    const int row0 = blockIdx.y * RB;
    const int nvalid = N - n0;
    const int8_t* xr[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) xr[r] = xi + size_t(min(row0 + r, B - 1)) * K;
    int d[RB][4] = {};
    if (nvalid > 0)
        for (int g = ty; g < K / group; g += TY)
            group_dot<FMT, MODE, VEC>(xr, packed, u, g, N, n0, nvalid, group, d);
    const int total = tile_total(d);
    const int tid = ty * TX + tx;
    if (tid < RB * COLS) {
        const int row = row0 + tid / COLS, col = blockIdx.x * COLS + tid % COLS;
        if (row < B && col < N) y[size_t(row) * N + col] = float(total);
    }
}

// v8: per group, the i32 dot of xi and the nibbles times the int8 scale code
// u, added to a float accumulator; minus xg2^T @ m2; times S per column.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
variant_w4a8_kernel(const int8_t* __restrict__ xi,      // [B, K]
                    const float* __restrict__ xg2,      // [K/group, B]
                    const uint8_t* __restrict__ packed, // q4 [K/2, N]
                    const int8_t* __restrict__ u,       // [K/group, N]
                    const bf16* __restrict__ m2,        // [K/group, N]
                    const float* __restrict__ S,        // [N]
                    float* __restrict__ y,              // [B, N]
                    int B, int K, int N, int group) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int n0 = blockIdx.x * COLS + 4 * tx;
    const int row0 = blockIdx.y * RB;
    const int nvalid = N - n0;
    int rows[RB];
    const int8_t* xr[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        rows[r] = min(row0 + r, B - 1);
        xr[r] = xi + size_t(rows[r]) * K;
    }
    float acc[RB][4] = {};
    if (nvalid > 0) {
        for (int g = ty; g < K / group; g += TY) {
            int d[RB][4] = {};
            group_dot<FMT_Q4, V_INT8, VEC>(xr, packed, nullptr, g, N, n0, nvalid, group, d);
            const uint32_t uw = load_bytes4(reinterpret_cast<const uint8_t*>(u) + size_t(g) * N + n0,
                                            nvalid, VEC);
            float mn[4];
            load_f4(m2 + size_t(g) * N + n0, nvalid, VEC, mn);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                const float xs = __ldg(xg2 + size_t(g) * B + rows[r]);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int uc = int(int8_t((uw >> (8 * c)) & 0xFFu));
                    acc[r][c] += float(d[r][c] * uc) - xs * mn[c];
                }
            }
        }
    }
    const float total = tile_total(acc);
    const int tid = ty * TX + tx;
    if (tid < RB * COLS) {
        const int row = row0 + tid / COLS, col = blockIdx.x * COLS + tid % COLS;
        if (row < B && col < N) y[size_t(row) * N + col] = total * __ldg(S + col);
    }
}

dim3 grid_of(int B, int N) { return dim3((N + COLS - 1) / COLS, (B + RB - 1) / RB); }

template <int FMT, int MODE>
void launch_float(bool vec, cudaStream_t st, const float* x, const float* xg,
                  const uint8_t* p, const bf16* s, const bf16* m, float* y, int B, int K,
                  int N, int group) {
    const dim3 block(TX, TY);
    if (vec)
        variant_float_kernel<FMT, MODE, true><<<grid_of(B, N), block, 0, st>>>(x, xg, p, s, m, y, B, K, N, group);
    else
        variant_float_kernel<FMT, MODE, false><<<grid_of(B, N), block, 0, st>>>(x, xg, p, s, m, y, B, K, N, group);
}

template <int MODE>
void launch_float_fmt(int fmt, bool vec, cudaStream_t st, const float* x, const float* xg,
                      const void* packed, const void* scales, const void* mins, float* y,
                      int B, int K, int N, int group) {
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    const bf16* s = static_cast<const bf16*>(scales);
    const bf16* m = static_cast<const bf16*>(mins);
    if (fmt == FMT_Q4) launch_float<FMT_Q4, MODE>(vec, st, x, xg, p, s, m, y, B, K, N, group);
    else launch_float<FMT_Q8, MODE>(vec, st, x, xg, p, s, m, y, B, K, N, group);
}

template <int FMT, int MODE>
void launch_int8(bool vec, cudaStream_t st, const int8_t* xi, const uint8_t* p,
                 const int8_t* u, float* y, int B, int K, int N, int group) {
    const dim3 block(TX, TY);
    if (vec)
        variant_int8_kernel<FMT, MODE, true><<<grid_of(B, N), block, 0, st>>>(xi, p, u, y, B, K, N, group);
    else
        variant_int8_kernel<FMT, MODE, false><<<grid_of(B, N), block, 0, st>>>(xi, p, u, y, B, K, N, group);
}

}  // namespace

// v2 (mode 0: y = x @ q, no panels) and v5 (mode 1: y = x @ (s*q) - xg^T @ m)
// in f32. fmt: 0 = q4, 1 = q8. scales, mins: bfloat16 [K/group, N] (mins may
// be null, and v2 reads neither); xg: float32 [K/group, B] (v5 with mins).
// vec: 1 when N % 4 == 0 and each panel is aligned to 4 of its elements.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int variant_f32_launch(const float* x, const float* xg, const void* packed,
                                  const void* scales, const void* mins, float* y, int B,
                                  int K, int N, int group, int fmt, int mode, int vec,
                                  void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mode == V_NOSCALE)
        launch_float_fmt<V_NOSCALE>(fmt, vec != 0, st, x, xg, packed, scales, mins, y, B, K, N, group);
    else
        launch_float_fmt<V_MINFOLD>(fmt, vec != 0, st, x, xg, packed, scales, mins, y, B, K, N, group);
    return int(cudaGetLastError());
}

// v6: y = bf16(x) @ bf16(q * s) - bf16(xg)^T @ m, products summed in f32.
// Arguments as variant_f32_launch.
extern "C" int variant_bf16_launch(const float* x, const float* xg, const void* packed,
                                   const void* scales, const void* mins, float* y, int B,
                                   int K, int N, int group, int fmt, int vec, void* stream) {
    launch_float_fmt<V_BF16>(fmt, vec != 0, static_cast<cudaStream_t>(stream), x, xg, packed,
                             scales, mins, y, B, K, N, group);
    return int(cudaGetLastError());
}

// v7 (mode 0: y = xi @ q), v9 (mode 1: y = xi @ wrap8(q * u), q4 only) and
// v10 (mode 2: y = sum (x_j + x_{j+h}) (lo_j + hi_j), q4 only), i32 sums
// written as float32. xi: int8 [B, K], 4-byte aligned rows (K % 16 == 0);
// u: int8 [K/group, N] (v9) or null.
extern "C" int variant_int8_launch(const void* xi, const void* packed, const void* u, float* y,
                                   int B, int K, int N, int group, int fmt, int mode, int vec,
                                   void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t* x8 = static_cast<const int8_t*>(xi);
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    const int8_t* u8 = static_cast<const int8_t*>(u);
    if (fmt != FMT_Q4) {
        if (mode != V_INT8) return int(cudaErrorInvalidValue);
        launch_int8<FMT_Q8, V_INT8>(vec != 0, st, x8, p, u8, y, B, K, N, group);
    } else if (mode == V_MULCOST) {
        launch_int8<FMT_Q4, V_MULCOST>(vec != 0, st, x8, p, u8, y, B, K, N, group);
    } else if (mode == V_4DOT) {
        launch_int8<FMT_Q4, V_4DOT>(vec != 0, st, x8, p, u8, y, B, K, N, group);
    } else {
        launch_int8<FMT_Q4, V_INT8>(vec != 0, st, x8, p, u8, y, B, K, N, group);
    }
    return int(cudaGetLastError());
}

// v8 (q4): y = S * [sum_g u_g * (xi @ q)_g - xg2^T @ m2], before the caller's
// per-row factor t. xg2: float32 [K/group, B]; u: int8 [K/group, N]; m2:
// bfloat16 [K/group, N]; S: float32 [N].
extern "C" int variant_w4a8_launch(const void* xi, const float* xg2, const void* packed,
                                   const void* u, const void* m2, const float* S, float* y,
                                   int B, int K, int N, int group, int vec, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 block(TX, TY);
    const int8_t* x8 = static_cast<const int8_t*>(xi);
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    const int8_t* u8 = static_cast<const int8_t*>(u);
    const bf16* m = static_cast<const bf16*>(m2);
    if (vec)
        variant_w4a8_kernel<true><<<grid_of(B, N), block, 0, st>>>(x8, xg2, p, u8, m, S, y, B, K, N, group);
    else
        variant_w4a8_kernel<false><<<grid_of(B, N), block, 0, st>>>(x8, xg2, p, u8, m, S, y, B, K, N, group);
    return int(cudaGetLastError());
}

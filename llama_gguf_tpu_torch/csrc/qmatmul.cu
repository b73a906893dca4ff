// Dequant-matmul kernels for Hopper (sm_90a): y = x @ W with W quantized.
//
// Replaces the Pallas kernels of llama_gguf_tpu/ops/qmatmul.py:
//   * q4  — _qmatmul_call with _q4_kernel/_acc_q4 (pallas_call in _qmatmul_call)
//   * q8  — _qmatmul_call with _q8_kernel/_acc_q8 (same call site)
//   * GLU — _qmatmul_glu_call with _glu_kernel/_glu_combine
//
// Layouts (quant/repack.py):
//   q4: packed uint8 [K/2, ldw]; packed row r belongs to scale group
//       g = r / (group/2) and holds element j = r % (group/2) of that group in
//       its low nibble and element j + group/2 in its high nibble.
//   q8: int8 [K, ldw].
//   scales, mins: float32 [K/group, ldw]; W[k, n] = s[g, n] * q[k, n] - m[g, n].
//
// What bounds them on this card: at decode batch sizes (B <= 8) the weight
// bytes (4.5 bits per weight plus the f32 scale/min panels) read once from
// HBM; at prefill sizes (hundreds of rows) the f32 multiply-adds on the CUDA
// cores (no tensor cores in this first cut).
//
// Design: a block owns a tile of COLS = 32 output columns and RB <= 8 rows
// and loops over all of K itself; nothing carries across blocks. Its 256
// threads are TX = 8 along N (each thread 4 adjacent columns, so one 32-bit
// load fetches 4 columns' bytes and a warp reads whole 32-byte sectors) by
// TY = 32 along K (scale groups dealt out round-robin). Nibbles are unpacked
// in registers straight from the group-split bytes. The min term is factored
// per group as s * sum(x * q) - m * sum(x), the same factorisation as the TPU
// kernels' _min_dot. The 32 K-partials are summed through shared memory. The
// GLU variant reads the gate columns and the up columns (offset F in the fused
// weight) in the same pass and writes act(gate) * up, so the [B, 2F]
// intermediate never reaches device memory. Ragged N and rows are masked.
// Accumulation and output are float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;
constexpr int TY = 32;
constexpr int COLS = 4 * TX;

enum { FMT_Q4 = 0, FMT_Q8 = 1 };
enum { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU = 2, ACT_RELU2 = 3, ACT_SWIGLU_OAI = 4 };

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

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Mirror of _glu_combine (llama_gguf_tpu/ops/qmatmul.py), f32 in and out.
__device__ __forceinline__ float glu_combine(float g, float u, int act) {
    switch (act) {
    case ACT_SWIGLU_OAI: {
        g = fminf(g, 7.0f);
        u = fminf(fmaxf(u, -7.0f), 7.0f);
        return (g * sigmoid(1.702f * g)) * (u + 1.0f);
    }
    case ACT_GELU: {
        const float c = 0.7978845608028654f;
        return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
    }
    case ACT_RELU: return fmaxf(g, 0.0f) * u;
    case ACT_RELU2: { const float m = fmaxf(g, 0.0f); return m * m * u; }
    default: return g * sigmoid(g) * u;
    }
}

// NW weight column sets: 1 for a plain product, 2 (gate at column n, up at
// column n + ncols of the fused weight) for the GLU.
template <int FMT, int RB, int NW>
__global__ void __launch_bounds__(TX * TY)
qmatmul_kernel(const float* __restrict__ x,        // [B, K]
               const uint8_t* __restrict__ packed,  // q4 [K/2, ldw] / q8 [K, ldw]
               const float* __restrict__ scales,    // [K/group, ldw]
               const float* __restrict__ mins,      // [K/group, ldw] or null
               float* __restrict__ y,               // [B, ncols]
               int B, int K, int ncols, int ldw, int group, int act, int vec) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int n0 = blockIdx.x * COLS + 4 * tx;
    const int row0 = blockIdx.y * RB;
    const int nvalid = ncols - n0;
    const bool has_mins = mins != nullptr;

    const float* xr[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) xr[r] = x + size_t(min(row0 + r, B - 1)) * K;

    float acc[NW][RB][4];
#pragma unroll
    for (int s = 0; s < NW; ++s)
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[s][r][c] = 0.0f;

    if (nvalid > 0) {
        const int ngroups = K / group;
        for (int g = ty; g < ngroups; g += TY) {
            float qd[NW][RB][4];
            float xs[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                xs[r] = 0.0f;
#pragma unroll
                for (int s = 0; s < NW; ++s)
#pragma unroll
                    for (int c = 0; c < 4; ++c) qd[s][r][c] = 0.0f;
            }
            const int k0 = g * group;
            if (FMT == FMT_Q4) {
                const int h = group >> 1;
                const uint8_t* prow = packed + size_t(g) * h * ldw + n0;
                for (int j = 0; j < h; ++j) {
                    uint32_t w[NW];
#pragma unroll
                    for (int s = 0; s < NW; ++s)
                        w[s] = load_bytes4(prow + size_t(j) * ldw + s * ncols, nvalid, vec);
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        const float xlo = __ldg(xr[r] + k0 + j);
                        const float xhi = __ldg(xr[r] + k0 + j + h);
                        xs[r] += xlo + xhi;
#pragma unroll
                        for (int s = 0; s < NW; ++s)
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const float lo = float((w[s] >> (8 * c)) & 0xFu);
                                const float hi = float((w[s] >> (8 * c + 4)) & 0xFu);
                                qd[s][r][c] = fmaf(xlo, lo, qd[s][r][c]);
                                qd[s][r][c] = fmaf(xhi, hi, qd[s][r][c]);
                            }
                    }
                }
            } else {
                const uint8_t* prow = packed + size_t(k0) * ldw + n0;
                for (int j = 0; j < group; ++j) {
                    uint32_t w[NW];
#pragma unroll
                    for (int s = 0; s < NW; ++s)
                        w[s] = load_bytes4(prow + size_t(j) * ldw + s * ncols, nvalid, vec);
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        const float xv = __ldg(xr[r] + k0 + j);
                        xs[r] += xv;
#pragma unroll
                        for (int s = 0; s < NW; ++s)
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const float q = float(int8_t((w[s] >> (8 * c)) & 0xFFu));
                                qd[s][r][c] = fmaf(xv, q, qd[s][r][c]);
                            }
                    }
                }
            }
#pragma unroll
            for (int s = 0; s < NW; ++s) {
                float sc[4], mn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                load_f4(scales + size_t(g) * ldw + s * ncols + n0, nvalid, vec, sc);
                if (has_mins) load_f4(mins + size_t(g) * ldw + s * ncols + n0, nvalid, vec, mn);
#pragma unroll
                for (int r = 0; r < RB; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[s][r][c] = fmaf(sc[c], qd[s][r][c], acc[s][r][c]) - mn[c] * xs[r];
            }
        }
    }

    // Sum the TY partials of every (row, column) through shared memory, one
    // weight set at a time; thread tid < RB * COLS owns output (tid / COLS,
    // tid % COLS) of the tile.
    __shared__ float red[TY][RB][COLS];
    const int tid = ty * TX + tx;
    float total[NW];
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
    if (tid < RB * COLS) {
        const int row = row0 + tid / COLS;
        const int col = blockIdx.x * COLS + tid % COLS;
        if (row < B && col < ncols)
            y[size_t(row) * ncols + col] =
                NW == 2 ? glu_combine(total[0], total[NW - 1], act) : total[0];
    }
}

int rows_per_block(int B) { return B >= 5 ? 8 : B >= 3 ? 4 : B == 2 ? 2 : 1; }

template <int FMT, int NW>
int launch(const float* x, const void* packed, const float* scales, const float* mins,
           float* y, int B, int K, int ncols, int ldw, int group, int act, int vec,
           cudaStream_t stream) {
    const int rb = rows_per_block(B);
    const dim3 block(TX, TY);
    const dim3 grid((ncols + COLS - 1) / COLS, (B + rb - 1) / rb);
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    switch (rb) {
    case 1: qmatmul_kernel<FMT, 1, NW><<<grid, block, 0, stream>>>(x, p, scales, mins, y, B, K, ncols, ldw, group, act, vec); break;
    case 2: qmatmul_kernel<FMT, 2, NW><<<grid, block, 0, stream>>>(x, p, scales, mins, y, B, K, ncols, ldw, group, act, vec); break;
    case 4: qmatmul_kernel<FMT, 4, NW><<<grid, block, 0, stream>>>(x, p, scales, mins, y, B, K, ncols, ldw, group, act, vec); break;
    default: qmatmul_kernel<FMT, 8, NW><<<grid, block, 0, stream>>>(x, p, scales, mins, y, B, K, ncols, ldw, group, act, vec); break;
    }
    return int(cudaGetLastError());
}

}  // namespace

// y[B, N] = x[B, K] @ W[K, N]. fmt: 0 = q4, 1 = q8. mins may be null.
// vec: 1 when N % 4 == 0 and every pointer is 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int qmatmul_launch(const float* x, const void* packed, const float* scales,
                              const float* mins, float* y, int B, int K, int N, int group,
                              int fmt, int vec, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return fmt == FMT_Q4
        ? launch<FMT_Q4, 1>(x, packed, scales, mins, y, B, K, N, N, group, 0, vec, s)
        : launch<FMT_Q8, 1>(x, packed, scales, mins, y, B, K, N, N, group, 0, vec, s);
}

// y[B, F] = act(x @ W[:, :F]) * (x @ W[:, F:]) over a fused [gate | up]
// weight W[K, 2F]. act: 0 silu, 1 gelu (tanh), 2 relu, 3 relu2, 4 swiglu_oai.
extern "C" int qmatmul_glu_launch(const float* x, const void* packed, const float* scales,
                                  const float* mins, float* y, int B, int K, int F, int group,
                                  int fmt, int act, int vec, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return fmt == FMT_Q4
        ? launch<FMT_Q4, 2>(x, packed, scales, mins, y, B, K, F, 2 * F, group, act, vec, s)
        : launch<FMT_Q8, 2>(x, packed, scales, mins, y, B, K, F, 2 * F, group, act, vec, s);
}

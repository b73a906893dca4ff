// The row-mapped causal depthwise convolution for Hopper (sm_90a): LFM2's
// short conv (L_cache taps over the B*x gate product) and the conv of the
// Mamba family's mixers, over one step's inputs with each row's conv
// window in front, the window kept in the cache and written back in place.
//
// The JAX package has no Pallas kernel for it (a few XLA ops, as
// ops/shortconv.causal_conv_plain, the plain version, still is); the port's
// launch plan (engine/runner.py) runs a few rows of a larger cache by a row
// map, so the conv reads and writes the cache row of each input row.
//
//   x      float32 [G, T, C]  the step's inputs (padding tokens zero)
//   state  float32 [B, K-1, C] every cache row's window, updated in place
//   w      float32 [K, C]      the taps; bias float32 [C] or null
//   nvalid int32 [G]           valid tokens of each input row (a prefix)
//   rows   int32 [G] or null   the cache row of each input row (null: g)
//   out    float32 [G, T, C]   out[g, t] = sum_k w[k] * seq[g, t + k] (+
//                              bias), seq = [state[rows[g]] | x[g]]
//
// A row with nvalid > 0 writes its new window, seq[nvalid .. nvalid+K-2],
// to state[rows[g]]; a row with none (padding, or a launch's spare place
// repeating its first row) writes nothing. So input rows that share a cache
// row never race on it as long as at most one of them is real; a padding
// row reading a window while the real row rewrites it reads old or new
// values, and its outputs are dropped by the caller.
//
// Rounding: each product and each sum rounded on its own, in the plain
// version's order (w[0] s[0], then + w[k] s[k], then + bias), with no
// fused multiply-add, so the kernel's outputs and windows equal the plain
// version's bit for bit.
//
// What bounds it on this card: bytes (2·K multiply-adds a value read). A
// thread owns one channel of one row over TCHUNK consecutive tokens, its
// window and taps in registers; a warp's loads and stores of a token are 32
// consecutive floats. Blocks tile channels x token chunks x rows, so a
// 512-token prefill row spreads over 16 x 32 blocks and a decode step's
// rows over 16 x 1 x G; a chunk after the first reads its K-1 leading
// inputs from x.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int TCHUNK = 16;    // tokens per block

template <int K>
__global__ void short_conv_kernel(const float* __restrict__ x, float* state,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const int* __restrict__ nvalid,
                                  const int* __restrict__ rows, float* __restrict__ out,
                                  int T, int C) {
    const int c = blockIdx.x * THREADS + threadIdx.x;
    if (c >= C) return;
    const int g = blockIdx.z;
    const int t0 = blockIdx.y * TCHUNK;
    const int row = rows != nullptr ? rows[g] : g;
    const float* xg = x + size_t(g) * T * C;
    float* st = state + size_t(row) * (K - 1) * C;

    float taps[K];
#pragma unroll
    for (int k = 0; k < K; ++k) taps[k] = w[size_t(k) * C + c];
    float win[K - 1];  // the K-1 inputs before the current token
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
        const int s = t0 - (K - 1) + j;
        win[j] = s >= 0 ? xg[size_t(s) * C + c] : st[size_t(s + K - 1) * C + c];
    }
    const float b = bias != nullptr ? bias[c] : 0.0f;

    const int t1 = min(t0 + TCHUNK, T);
    for (int t = t0; t < t1; ++t) {
        const float xt = xg[size_t(t) * C + c];
        float acc = __fmul_rn(win[0], taps[0]);
#pragma unroll
        for (int k = 1; k < K; ++k)
            acc = __fadd_rn(acc, __fmul_rn(k < K - 1 ? win[k] : xt, taps[k]));
        if (bias != nullptr) acc = __fadd_rn(acc, b);
        out[(size_t(g) * T + t) * C + c] = acc;
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[j] = j + 1 < K - 1 ? win[j + 1] : xt;
    }

    if (blockIdx.y != 0) return;
    const int n = nvalid[g];
    if (n <= 0) return;
    float next[K - 1];  // seq[n .. n+K-2], read before any of it is written
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
        const int i = n + j;
        next[j] = i < K - 1 ? st[size_t(i) * C + c] : xg[size_t(i - (K - 1)) * C + c];
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j) st[size_t(j) * C + c] = next[j];
}

template <int K>
void launch(dim3 grid, cudaStream_t st, const float* x, float* state, const float* w,
            const float* bias, const int* nvalid, const int* rows, float* out, int T,
            int C) {
    short_conv_kernel<K><<<grid, THREADS, 0, st>>>(x, state, w, bias, nvalid, rows, out, T,
                                                   C);
}

}  // namespace

// The launch: G input rows of T tokens over C channels, K taps (2-8).
extern "C" int short_conv_launch(const float* x, float* state, const float* w,
                                 const float* bias, const int* nvalid, const int* rows,
                                 float* out, int G, int T, int C, int K, void* stream) {
    if (G <= 0 || T <= 0 || C <= 0) return 0;
    if (G > 65535) return int(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((C + THREADS - 1) / THREADS, (T + TCHUNK - 1) / TCHUNK, G);
    switch (K) {
        case 2: launch<2>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 3: launch<3>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 4: launch<4>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 5: launch<5>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 6: launch<6>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 7: launch<7>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        case 8: launch<8>(grid, st, x, state, w, bias, nvalid, rows, out, T, C); break;
        default: return int(cudaErrorInvalidValue);
    }
    return int(cudaGetLastError());
}
